"""The PyTorch port stands alone: no JAX, no ``ml_dtypes``, nothing of the
JAX package; its entry points default to the card and never fall back to
the CPU; its kernel-launch counters count kernel launches only."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.core import nvfp4
from repro_torch.kernels import _build, ops
from repro_torch.launch import serve, train
from repro_torch.serve import Engine

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 15
    assert {PORT / "distributed" / "ctx.py", PORT / "distributed" / "sharding.py",
            PORT / "launch" / "mesh.py", PORT / "data" / "generated.py",
            PORT / "obs" / "numerics.py", PORT / "obs" / "metrics.py",
            PORT / "obs" / "schema.py", PORT / "obs" / "validate.py",
            PORT / "obs" / "compare.py", PORT / "obs" / "export.py",
            PORT / "obs" / "trace.py", PORT / "obs" / "dispatch.py",
            PORT / "models" / "rglru.py", PORT / "serve" / "state.py",
            PORT / "models" / "rwkv6.py", PORT / "models" / "whisper.py",
            PORT / "spec" / "__init__.py", PORT / "spec" / "proposer.py",
            PORT / "spec" / "engine.py", PORT / "distributed" / "fault.py",
            PORT / "optim" / "compression.py", PORT / "core" / "qad.py",
            PORT / "launch" / "train.py", PORT / "checkpoint" / "manager.py",
            PORT / "core" / "losses.py", PORT / "core" / "qconfig.py",
            PORT / "models" / "layers.py", PORT / "models" / "decoder.py",
            PORT / "models" / "common.py"} <= set(files)
    bad = {(str(f.relative_to(SRC)), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN}
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.bridge, repro_torch.serve, repro_torch.models.layers, "
            "repro_torch.kernels.nvfp4_matmul, repro_torch.distributed.ctx, "
            "repro_torch.distributed.sharding, repro_torch.launch.mesh, "
            "repro_torch.data.generated, repro_torch.core.ptq, "
            "repro_torch.obs.validate, repro_torch.obs.compare, "
            "repro_torch.obs.export, repro_torch.obs.numerics, "
            "repro_torch.obs.trace, repro_torch.obs.dispatch, "
            "repro_torch.models.rglru, repro_torch.serve.state, "
            "repro_torch.models.rwkv6, repro_torch.models.whisper, "
            "repro_torch.spec, repro_torch.spec.proposer, "
            "repro_torch.spec.engine, repro_torch.distributed.fault, "
            "repro_torch.optim.compression, repro_torch.core.qad, "
            "repro_torch.checkpoint.manager, repro_torch.core.losses, "
            "repro_torch.core.qconfig, repro_torch.models.decoder, "
            "repro_torch.models.common; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is usable")
    cfg = configs.get_smoke("acereason-7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.load_quantized(cfg, 0, "packed")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "acereason-7b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train("olmo-1b", steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "olmo-1b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, {"embed": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "acereason-7b", "--engine"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.load_quantized(configs.get_smoke("qwen2-moe-a2.7b"), 0, "packed")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen2-moe-a2.7b", "--engine"])
    for arch in ("rwkv6-3b", "whisper-tiny", "qwen2-vl-2b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", arch, "--engine"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "arctic-480b", "--engine", "--speculative", "3"])
    from repro_torch.spec import SpecEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        SpecEngine(cfg, {"embed": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train("rwkv6-3b", steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train("olmo-1b", steps=1, mesh=(2, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1", "--mesh", "2x2", "--rules", "tp_only"])
    assert train.build_parser().parse_args([]).device == "cuda"


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch functions take CUDA tensors only; the ops choose the plain
    version for CPU tensors, so the CPU path never reaches them."""
    from repro_torch.kernels import kl_loss, nvfp4_matmul, nvfp4_qdq
    from repro_torch.kernels import paged_attention
    x = torch.zeros(2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        nvfp4_qdq.launch(x)
    with pytest.raises(ValueError, match="CUDA"):
        nvfp4_matmul.launch(x, ops.pack_weight(torch.zeros(32, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        nvfp4_matmul.launch_grouped(x.reshape(1, 2, 32),
                                    nvfp4.pack(torch.zeros(1, 16, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        nvfp4_matmul.launch_tp(x, ops.pack_weight(torch.zeros(32, 16)),
                               _one_rank(), "column")
    with pytest.raises(ValueError, match="CUDA"):
        kl_loss.launch_fwd(x, x)
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        kl_loss.launch_bwd(x, x, z, z, z)
    pages = torch.zeros(4, 8, 1, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.launch(x.reshape(1, 1, 2, 32), pages, pages,
                               torch.zeros(1, 4, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32))


def test_launch_counters_count_kernel_launches_only():
    ops.reset_launches()
    x = torch.randn(4, 64).to(torch.bfloat16)
    y = ops.nvfp4_qdq(x)
    z = ops.nvfp4_matmul(y, ops.pack_weight(torch.randn(64, 48)))
    assert z.shape == (4, 48) and z.dtype == torch.bfloat16
    s = torch.randn(4, 64, requires_grad=True)
    ops.kl_loss(x, s, torch.ones(4)).backward()
    assert s.grad.shape == (4, 64)
    pool = {"k": torch.randn(4, 8, 1, 32).to(torch.bfloat16),
            "v": torch.randn(4, 8, 1, 32).to(torch.bfloat16)}
    out = ops.paged_attention(x[:1].reshape(1, 1, 2, 32), pool,
                              torch.tensor([[2, 0]], dtype=torch.int32),
                              torch.tensor([5], dtype=torch.int32))
    assert out.shape == (1, 1, 2, 32) and out.dtype == torch.bfloat16
    g = ops.nvfp4_matmul_grouped(x.reshape(2, 2, 64),
                                 nvfp4.pack(torch.randn(2, 8, 64)))
    assert g.shape == (2, 2, 8) and g.dtype == torch.bfloat16
    t = ops.nvfp4_matmul_tp(y, ops.pack_weight(torch.randn(64, 48)),
                            _one_rank(), "column")
    assert t.shape == (4, 48) and t.dtype == torch.bfloat16
    assert ops.launches == {"nvfp4_qdq": 0, "nvfp4_matmul": 0,
                            "nvfp4_matmul_grouped": 0, "nvfp4_matmul_tp": 0,
                            "kl_loss": 0, "kl_loss_bwd": 0,
                            "paged_attention": 0}


def _one_rank():
    """A tensor-parallel context without a group (column mode needs no
    collective)."""
    from repro_torch.distributed.ctx import TP
    return TP(group=None, rank=0, size=1, device=torch.device("cpu"))


def test_tp_entry_points_default_to_cuda():
    """The TP paths default to the card too: the CLI's ranks and the
    tile loader."""
    assert serve.build_parser().parse_args(["--tp", "2"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.load_quantized(configs.get_smoke("acereason-7b"), 0, "packed",
                             tp=_one_rank())
    with pytest.raises(SystemExit, match="--engine"):
        serve.main(["--tp", "2", "--device", "cpu"])


def test_build_is_lazy_and_names_the_sources():
    """Importing builds nothing; the library name hashes every source."""
    assert _build.library.cache_info().currsize == 0
    names = {p.name for p in _build._sources()}
    assert {"nvfp4_qdq.cu", "nvfp4_matmul.cu", "nvfp4_matmul_grouped.cu",
            "nvfp4_matmul.cuh", "kl_loss.cu", "paged_attention.cu"} <= names
    assert len(_build._digest()) == 16
    assert set(_build.SIGNATURES) == {"nvfp4_qdq", "nvfp4_matmul",
                                      "nvfp4_matmul_grouped", "kl_fwd",
                                      "kl_bwd", "paged_attention"}
