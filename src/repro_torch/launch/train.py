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

On a data x model mesh (``--mesh DxM --rules R``, ``train(mesh=(D, M),
rules=R)``) ``train`` spawns D x M ranks (gloo processes; on the card
they share it, every collective through host memory) and each runs
``train_on_mesh``: the same loop over its stored shards under one of the
reference's four sharding rules (``fsdp_tp``, ``fsdp_only``, ``tp_only``,
``dp_only``), rank 0 printing, with the same options: ``--ckpt-dir``
(rank 0 writes the gathered state in the one-device format, every rank
restores its shards, so checkpoints move between a mesh and one device
both ways), ``--numerics`` / ``--metrics-out`` (every rank's probes the
same; rank 0 writes) and every ``--method``, for every family: the dense
and MoE decoders, the RG-LRU hybrids and RWKV6 on the token batches
here.  Whisper and the VLM have no batch maker here, as in the
reference: they train on a mesh through ``core.qad.make_train_step(...,
mesh=, rules=)`` on their own batches (``enc_frames``; ``pos3``,
``vis_embeds``, ``vis_mask``), each rank given the global batch.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --mesh 2x2 --rules fsdp_tp --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --mesh 2x2 --rules fsdp_tp --arch rwkv6-3b --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --mesh 2x2 --rules fsdp_tp --arch qwen2-moe-a2.7b --steps 2 \
        --method qad_chunked --numerics --ckpt-dir ckpt

Runs on ``cuda`` unless given ``--device cpu`` / ``device="cpu"``, and
raises without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..core import qad as qad_mod
from ..data import DataConfig, eval_batches, make_batch
from ..distributed import sharding
from ..distributed.fault import StragglerMonitor
from ..kernels import ops
from ..models import get_model
from ..models.common import tree_leaves
from ..obs import export as obs_export
from ..obs.metrics import MetricsRegistry
from ..obs.numerics import NumericsRecorder
from ..optim import AdamW, warmup_cosine
from . import mesh as launch_mesh
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


def _run(step_fn, eval_fn, holder: list, dcfg, evals, start, steps,
         eval_every, batch, seq, log, device, recorder=None,
         metrics_out=None, registry=None, mgr=None):
    """The training loop: (state, history); ``eval_every=0`` runs no eval
    and records no history.  The state is taken out of ``holder`` (a
    one-element list), so that no caller's name keeps the initial state
    alive beside the trained one."""
    state = holder.pop()
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
        if eval_every and ((i + 1) % eval_every == 0 or i == steps - 1):
            ev = eval_fn(state, evals)
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
    return state, history


def _probes(qcfg, on: bool) -> tuple:
    """(registry, recorder, the train step's policy): the numerics probes'
    recorder and the policy with ``numerics`` on, or (None, None, qcfg)."""
    if not on:
        return None, None, qcfg
    registry = MetricsRegistry()
    return (registry, NumericsRecorder(registry),
            dataclasses.replace(qcfg, numerics=True))


def check_mesh(cfg, rules: str, shape: tuple | None = None) -> None:
    """Refuse, with one line before any rank starts, rules the mesh does
    not know, and a config whose attention heads do not split over the
    mesh's model group (``shape``: (data, model)) under rules that split
    over it, as every rank's fused QKV tile would refuse them
    (``sharding.local_heads``)."""
    if rules not in sharding.RULE_MODES:
        raise ValueError(f"unknown sharding rules {rules!r}: one of "
                         f"{', '.join(sharding.RULE_MODES)}")
    if (shape is not None and shape[1] > 1 and cfg.family != "rwkv6"
            and rules in ("fsdp_tp", "tp_only")):
        sharding.local_heads(cfg.n_heads, cfg.n_kv_heads, shape[1])


class MeshCheckpoints:
    """``train``'s checkpoints on a training mesh, in the one-device
    format: ``save`` gathers the whole state from every rank's shards (a
    collective) and rank 0 writes it (async, keep-k); ``restore_latest``
    gives every rank its own shards of the newest valid step."""

    def __init__(self, directory: str, mesh, model, cfg, rules):
        self.mgr = CheckpointManager(directory)
        self.mesh, self.model, self.cfg, self.rules = mesh, model, cfg, rules

    def save(self, step: int, state, metrics: dict | None = None) -> None:
        keep = self.mesh.rank == 0
        whole = qad_mod.gather_state(state, self.model, self.cfg, self.mesh,
                                     self.rules, keep)
        if keep:
            self.mgr.save(step, whole, metrics)

    def _world_max(self, v: float) -> float:
        world = self.mesh.world
        if world.size == 1:
            return v
        return float(world.all_reduce(torch.tensor([v], device=world.device),
                                      "max")[0])

    def wait(self) -> None:
        """Rank 0's write done, and every rank past it (a later run may
        restore what it wrote)."""
        self.mgr.wait()
        self._world_max(0.0)

    def restore_latest(self, shards):
        """Rank 0 picks the newest valid step, every rank restores it."""
        mine = self.mgr.latest_step() if self.mesh.rank == 0 else None
        step = int(self._world_max(-1.0 if mine is None else float(mine)))
        if step < 0:
            return None
        return step, self.mgr.restore(step, shards, qad_mod.shard_cutter(
            self.model, self.cfg, self.mesh, self.rules))


def train_on_mesh(mesh, cfg, rules: str = "fsdp_tp", steps: int = 200,
                  lr: float = 1e-3, method: str = "qad", batch: int = 8,
                  seq: int = 64, eval_every: int = 50, seed: int = 0,
                  domains: tuple = ("math", "code", "prose"), log=print,
                  ckpt_dir: str | None = None, numerics: bool = False,
                  metrics_out: str | None = None):
    """One rank of ``train(mesh=...)``: ``train``'s loop over this rank's
    stored shards of ``cfg`` on ``mesh`` (a ``distributed.ctx.Mesh``)
    under the ``rules`` table, with ``train``'s checkpoint resume
    (``MeshCheckpoints``), numerics probes (every rank's the same; rank 0
    writes ``metrics_out``) and methods.  Returns (state, history,
    report); every rank's history is the same.  The report: ``launches``
    (the kernel counters, reset at the start), ``collectives`` (each
    step's calls and host seconds by group), ``bytes`` (the stored
    student, teacher and moments, and each one's share by the partition
    factors), each step's ``loss`` and ``step_s``, ``start`` (the step
    resumed from), ``numerics`` (the recorder's summary, with the probes
    on) and, on the card, ``peak_gb``."""
    check_mesh(cfg, rules, (mesh.shape["data"], mesh.shape["model"]))
    device = mesh.device
    model = get_model(cfg)
    table = sharding.make_rules(rules)
    qcfg = specs.recipe_qconfig(cfg)
    qadcfg = make_method_qad(method)
    registry, recorder, train_qcfg = _probes(qcfg,
                                             numerics or bool(metrics_out))
    opt = AdamW(lr=warmup_cosine(lr, steps // 10, steps), clip_norm=1.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        state = qad_mod.init_state_on_mesh(model, cfg, gen, opt, mesh, table)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed, domains=domains)
    step_fn = qad_mod.make_train_step(model, cfg, train_qcfg, opt, qadcfg,
                                      mesh=mesh, rules=table)
    eval_fn = qad_mod.make_eval_step(model, cfg, qcfg, qadcfg,
                                     mesh=mesh, rules=table)
    evals = eval_batches(dcfg, 2, device=device) if eval_every else []
    mgr = (MeshCheckpoints(ckpt_dir, mesh, model, cfg, table)
           if ckpt_dir else None)
    start = 0
    if mgr is not None:
        restored = mgr.restore_latest(state)
        if restored is not None:
            start, state = restored
            log(f"[train] resumed from step {start}")
    counts, step_s, losses = [], [], []

    def timed(state, b):
        mesh.reset_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        counts.append(mesh.counts())
        losses.append(float(metrics["loss"]))
        return state, metrics

    ops.reset_launches()
    holder = [state]
    del state
    state, history = _run(timed, eval_fn, holder, dcfg, evals, start, steps,
                          eval_every, batch, seq, log, device, recorder,
                          metrics_out if mesh.rank == 0 else None, registry,
                          mgr)
    if mgr is not None:
        mgr.wait()
    specs_ = model.param_specs(cfg)
    places = sharding.placements(specs_, mesh.shape, table)
    share = lambda tree: sharding.stored_share(
        tree, specs_, places, qad_mod._heads(cfg), mesh.shape)
    report = {"launches": dict(ops.launches), "collectives": counts,
              "loss": losses, "step_s": step_s, "bytes": {
                  "student": share(state.student),
                  "teacher": share(state.teacher),
                  "moments": tuple(map(sum, zip(*(
                      share(t) for t in state.opt_state))))},
              "start": start,
              "numerics": recorder.summary() if recorder is not None else None}
    if device.type == "cuda":
        report["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return state, history, report


def _train_rank(mesh, cfg, kwargs) -> dict:
    """A rank of ``train(mesh=...)``: its history and report (rank 0
    prints)."""
    log = print if mesh.rank == 0 else (lambda msg: None)
    _, history, report = train_on_mesh(mesh, cfg, log=log, **kwargs)
    return {"history": history, "report": report}


def train(arch: str, smoke: bool = True, steps: int = 200, lr: float = 1e-3,
          method: str = "qad", batch: int = 8, seq: int = 64,
          ckpt_dir: str | None = None, eval_every: int = 50,
          seed: int = 0, domains: tuple = ("math", "code", "prose"),
          numerics: bool = False, metrics_out: str | None = None,
          log=print, device="cuda", mesh: tuple | None = None,
          rules: str = "fsdp_tp"):
    """Train for ``steps`` steps; returns (state, history).  Each history
    entry holds one eval (mean over 2 held-out batches) with the step, the
    train loss and the step's wall time ``step_s``.  ``numerics``: probes
    on the train step, recorded at every eval; ``metrics_out``: a
    snapshot written there at every eval.

    ``mesh`` = (data, model): spawn data x model ranks on ``device`` under
    ``rules``; returns (the ranks' results, history): each result is
    ``{"history", "report"}`` (``train_on_mesh``), the history rank 0's."""
    device = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    if mesh is not None:
        check_mesh(cfg, rules, tuple(mesh))
        kwargs = dict(rules=rules, steps=steps, lr=lr, method=method,
                      batch=batch, seq=seq, eval_every=eval_every, seed=seed,
                      domains=domains, ckpt_dir=ckpt_dir, numerics=numerics,
                      metrics_out=metrics_out)
        ranks = launch_mesh.spawn_mesh(_train_rank, tuple(mesh), cfg, kwargs,
                                       device=device)
        return ranks, ranks[0]["history"]
    model = get_model(cfg)
    qcfg = specs.recipe_qconfig(cfg)
    qadcfg = make_method_qad(method)

    registry, recorder, train_qcfg = _probes(qcfg, numerics)

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

    holder = [state]
    del state
    state, history = _run(step_fn, eval_fn, holder, dcfg, evals, start,
                          steps, eval_every, batch, seq, log, device,
                          recorder, metrics_out, registry, mgr)
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
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train on a data x model mesh of gloo ranks "
                    "(e.g. 2x2)")
    ap.add_argument("--rules", default="fsdp_tp", choices=sharding.RULE_MODES,
                    help="the sharding rules on --mesh")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh = (tuple(int(v) for v in args.mesh.lower().split("x"))
            if args.mesh else None)
    try:
        _, history = train(args.arch, args.smoke, args.steps, args.lr,
                           args.method, args.batch, args.seq, args.ckpt_dir,
                           numerics=args.numerics or bool(args.metrics_out),
                           metrics_out=args.metrics_out, device=args.device,
                           mesh=mesh, rules=args.rules)
    except NotImplementedError as e:
        print(f"[train] unsupported: {e}", file=sys.stderr)
        sys.exit(1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
