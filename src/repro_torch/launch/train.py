"""QAD training driver (port of ``repro.launch.train``).

Random BF16 weights from ``seed`` are the teacher and, fake-quantized to
NVFP4, the student; each step distills the teacher into the student
(``--method qad``) on the deterministic synthetic corpus, with a
Table-1-style eval (KL against the teacher, CE against the labels), the
straggler monitor, and auto-resume from the newest valid checkpoint.  On
the card the student's fake quant runs the ``nvfp4_qdq`` kernel and the
KL its forward and backward kernels.  The layers run under the config's
rematerialization (``cfg.remat``).

``--numerics`` turns on the numerics probes for the train step only
(per-layer SQNR, clip fraction and scale utilization of every quantized
site, the teacher-student hidden divergence and per-layer gradient norms;
the step's state is bitwise unchanged); the eval step stays probe-free.
``--metrics-out PATH`` (implies ``--numerics``) writes a
``repro.obs.metrics/v1`` snapshot there at every eval interval, with its
Prometheus text beside it (``PATH`` with a ``.prom`` extension).

    PYTHONPATH=src python -m repro_torch.launch.train --full --arch olmo-1b --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 60
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2 \
        --numerics --metrics-out m.json

Runs on ``cuda`` unless given ``--device cpu`` / ``device="cpu"``, and
raises without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..core import qad as qad_mod
from ..data import DataConfig, eval_batches, make_batch
from ..distributed.fault import StragglerMonitor
from ..models import get_model
from ..obs import export as obs_export
from ..obs.metrics import MetricsRegistry
from ..obs.numerics import NumericsRecorder
from ..optim import AdamW, warmup_cosine
from . import specs
from .serve import resolve_device

METHODS = ("qad", "qat", "qad_mse", "qad_chunked")


def make_method_qad(method: str) -> qad_mod.QADConfig:
    if method == "qad":
        return qad_mod.QADConfig(loss="kl")
    if method == "qat":
        return qad_mod.QADConfig(loss="ce")
    if method == "qad_mse":
        return qad_mod.QADConfig(loss="mse")
    if method == "qad_chunked":
        return qad_mod.QADConfig(loss="kl", use_chunked_loss=True)
    raise ValueError(method)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(arch: str, smoke: bool = True, steps: int = 200, lr: float = 1e-3,
          method: str = "qad", batch: int = 8, seq: int = 64,
          ckpt_dir: str | None = None, eval_every: int = 50,
          seed: int = 0, domains: tuple = ("math", "code", "prose"),
          numerics: bool = False, metrics_out: str | None = None,
          log=print, device="cuda"):
    """Train for ``steps`` steps; returns (state, history).  Each history
    entry holds one eval (mean over 2 held-out batches) with the step, the
    train loss and the step's wall time ``step_s``.  ``numerics``: probes
    on the train step, recorded at every eval; ``metrics_out``: a
    snapshot written there at every eval."""
    device = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    model = get_model(cfg)
    qcfg = specs.recipe_qconfig(cfg)
    qadcfg = make_method_qad(method)

    registry = recorder = None
    train_qcfg = qcfg
    if numerics:
        registry = MetricsRegistry()
        recorder = NumericsRecorder(registry)
        train_qcfg = dataclasses.replace(qcfg, numerics=True)

    opt = AdamW(lr=warmup_cosine(lr, steps // 10, steps), clip_norm=1.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    # the teacher stands for a post-trained BF16 model: a fresh init here
    with torch.no_grad():
        state = qad_mod.init_state(model, cfg, gen, opt, with_teacher=True,
                                   device=device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed, domains=domains)
    step_fn = qad_mod.make_train_step(model, cfg, train_qcfg, opt, qadcfg)
    eval_fn = qad_mod.make_eval_step(model, cfg, qcfg, qadcfg)
    evals = eval_batches(dcfg, 2, device=device)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None:
        restored = mgr.restore_latest(state)
        if restored is not None:
            start, state = restored
            log(f"[train] resumed from step {start}")

    mon = StragglerMonitor()
    history = []
    for i in range(start, steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, make_batch(dcfg, i, device=device))
        _sync(device)
        dt = time.perf_counter() - t0
        action = mon.feed(dt)
        if action:
            log(f"[fault] straggler monitor: {action} at step {i}")
        if (i + 1) % eval_every == 0 or i == steps - 1:
            ev = [eval_fn(state, eb) for eb in evals]
            m = {k: float(torch.mean(torch.stack([e[k] for e in ev])))
                 for k in ev[0]}
            m["step"] = i + 1
            m["loss"] = float(metrics["loss"])
            m["step_s"] = dt
            history.append(m)
            log(f"[train] step {i+1} " +
                " ".join(f"{k}={v:.4f}" for k, v in m.items() if k != "step"))
            if recorder is not None:
                recorder.record(metrics.get("numerics") or {})
                recorder.series_point("qad_train_kl", i + 1, m.get("kl"))
                recorder.series_point("qad_train_top1", i + 1,
                                      m.get("top1_agree"))
                if metrics_out:
                    obs_export.write_training_metrics(
                        metrics_out, i + 1, registry, recorder=recorder,
                        tokens=(i + 1) * batch * seq, evals=m)
                    log(f"[train] wrote {metrics_out} (+ .prom)")
            if mgr is not None:
                mgr.save(i + 1, state, metrics=m)
    if mgr is not None:
        mgr.wait()
    return state, history


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmo-1b", choices=configs.ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the full-size config (on the card)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--method", default="qad", choices=METHODS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", default=None, help="write the history as JSON")
    ap.add_argument("--numerics", action="store_true",
                    help="per-layer quantization-error + teacher-student "
                    "divergence probes on the train step (the optimizer "
                    "math is bitwise unchanged)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a repro.obs.metrics/v1 snapshot here at "
                    "every eval interval (implies --numerics)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    _, history = train(args.arch, args.smoke, args.steps, args.lr,
                       args.method, args.batch, args.seq, args.ckpt_dir,
                       numerics=args.numerics or bool(args.metrics_out),
                       metrics_out=args.metrics_out, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
