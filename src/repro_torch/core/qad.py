"""QAD / QAT step factories (port of ``repro.core.qad``).

``make_train_step(model, cfg, qcfg, opt, qad)`` builds
``step(state, batch) -> (state, metrics)``:

  * **QAD** (``loss="kl"``): the teacher is the frozen BF16 parameters; the
    student has the same architecture with an NVFP4 fake-quant forward;
    the loss is KL(p_t || p_s) at temperature 1.
  * **QAT** (``loss="ce"``): the student alone, next-token cross entropy.
  * ablations: ``loss="mse"`` (logit MSE, Table 8) and ``loss="kl+ce"``.

The teacher forward runs under ``torch.no_grad()``.  The KL goes through
``kernels.ops.kl_loss`` on the flattened [B*S, V] logits: on the card its
forward and backward are the K5 and K6 kernels.  The student's fake quant
goes through ``ops.nvfp4_qdq`` (the K1 kernel forward, straight-through
backward).  Metrics: the loss, the paper's Table-1 diagnostics (KL against
the teacher and CE against the labels), top-1 agreement, and the global
norms of the gradient and of the update, all as 0-dim tensors.

With ``qcfg.numerics`` on, the step also returns ``metrics["numerics"]``:
the student's per-layer quantization-error probes, the per-layer
teacher-student hidden divergence and the per-layer gradient norms
(``obs.numerics``); the step's state is bitwise the same as without.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..kernels import ops
from ..models.common import tree_leaves, tree_map
from ..obs import numerics as obs_numerics
from ..optim.adamw import AdamW, global_norm
from . import losses
from .qconfig import BF16, QuantConfig


class TrainState(NamedTuple):
    step: torch.Tensor          # int32, 0-dim
    student: Any                # trainable parameters (nested dict)
    teacher: Any | None         # frozen BF16 parameters (None for pure QAT)
    opt_state: Any


@dataclasses.dataclass(frozen=True)
class QADConfig:
    loss: str = "kl"            # kl | ce | mse | kl+ce
    ce_weight: float = 0.1      # for kl+ce
    use_chunked_loss: bool = False
    loss_chunks: int = 16
    temperature: float = 1.0    # the paper uses T=1


def init_state(model, cfg, gen: torch.Generator, opt: AdamW,
               with_teacher: bool = True, device="cuda") -> TrainState:
    params = model.init_params(cfg, gen, device)
    teacher = tree_map(torch.clone, params) if with_teacher else None
    return TrainState(step=torch.zeros((), dtype=torch.int32,
                                       device=torch.device(device)),
                      student=params, teacher=teacher,
                      opt_state=opt.init(params))


def _flat_kl(t_logits: torch.Tensor, s_logits: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    v = s_logits.shape[-1]
    return ops.kl_loss(t_logits.reshape(-1, v), s_logits.reshape(-1, v),
                       mask.reshape(-1))


def make_loss_fn(model, cfg, qcfg: QuantConfig, qad: QADConfig):
    """``loss(student, teacher, batch) -> (loss, metrics)``; the metrics
    carry no gradient."""

    def loss_fn(student, teacher, batch):
        mask = batch["mask"].to(torch.float32)
        temp = qad.temperature

        if qad.use_chunked_loss and qad.loss == "kl":
            h_s = model.apply(cfg, student, batch, qcfg, output="hidden")
            with torch.no_grad():
                h_t = model.apply(cfg, teacher, batch, BF16, output="hidden")
                w_t = model.unembed(cfg, teacher)
            w_s = model.unembed(cfg, student)
            # the same lm_head quantization as the plain path
            h_s = qcfg.q_act(h_s, "lm_head")
            w_s = qcfg.q_weight(w_s, "lm_head", contract_axis=0)
            kl = losses.chunked_kl_loss(h_t, w_t, h_s, w_s, mask,
                                        qad.loss_chunks)
            return kl, {"kl": kl.detach()}

        # numerics probes (obs.numerics): with qcfg.numerics on, a local
        # tape collects per-layer quant-error stats from the student
        # forward and per-layer hiddens from both forwards
        tape = obs_numerics.Tape() if qcfg.numerics else None
        if tape is not None:
            with obs_numerics.collecting(tape):
                s_logits = model.apply(cfg, student, batch, qcfg)
            s_aux = tape.drain()
        else:
            s_logits = model.apply(cfg, student, batch, qcfg)
        metrics = {}
        if qad.loss in ("ce", "kl+ce"):
            ce = losses.ce_from_logits(s_logits, batch["labels"], mask)
            metrics["ce"] = ce.detach()
        else:
            with torch.no_grad():
                metrics["ce"] = losses.ce_from_logits(s_logits.detach(),
                                                      batch["labels"], mask)
        if qad.loss == "ce":                       # QAT
            if tape is not None:
                metrics["numerics"] = _numerics_metrics(s_aux, None, mask)
            return ce, metrics

        with torch.no_grad():
            if tape is not None:
                with obs_numerics.collecting(tape):
                    t_logits = model.apply(
                        cfg, teacher, batch,
                        dataclasses.replace(BF16, numerics=True))
                t_aux = tape.drain()
            else:
                t_logits = model.apply(cfg, teacher, batch, BF16)
        if temp != 1.0:
            t_in, s_in = t_logits / temp, s_logits / temp
        else:
            t_in, s_in = t_logits, s_logits
        if qad.loss == "mse":
            with torch.no_grad():
                kl = _flat_kl(t_in, s_in.detach(), mask)
        else:
            kl = _flat_kl(t_in, s_in, mask)
        metrics["kl"] = kl.detach()
        with torch.no_grad():
            metrics["top1_agree"] = losses.top1_agreement(
                t_logits, s_logits.detach(), mask)
        if tape is not None:
            metrics["numerics"] = _numerics_metrics(s_aux, t_aux, mask)

        if qad.loss == "kl":                       # QAD
            return kl, metrics
        if qad.loss == "mse":                      # Table 8 ablation
            mse = losses.mse_from_logits(t_logits, s_logits, mask)
            metrics["mse"] = mse.detach()
            return mse, metrics
        if qad.loss == "kl+ce":
            return kl + qad.ce_weight * ce, metrics
        raise ValueError(qad.loss)

    return loss_fn


def _numerics_metrics(s_aux: dict, t_aux: dict | None,
                      mask: torch.Tensor) -> dict:
    """The drained probe tapes as ``metrics["numerics"]``: the two
    forwards' per-layer hiddens (``layers.hidden``) reduced to per-layer
    cosine / MSE, every other student probe site passed through as
    ``{site: {stat: tensor}}``, all without gradient."""
    out = {}
    h_s = s_aux.pop("layers.hidden", None)
    h_t = t_aux.pop("layers.hidden", None) if t_aux else None
    if h_s is not None and h_t is not None:
        out["layers.hidden"] = obs_numerics.hidden_divergence(
            h_t["h"], h_s["h"], mask)
    for site, stats in s_aux.items():
        out[site] = {k: v.detach() for k, v in stats.items()}
    return out


def _layer_grad_norms(layer_grads) -> torch.Tensor:
    """[n_layers] f32: the gradient norm of each layer, over every leaf of
    the stacked layer tree (each leaf carries the [n_layers, ...] axis)."""
    sq = sum(torch.sum(torch.square(g.to(torch.float32)).reshape(g.shape[0], -1),
                       -1)
             for g in tree_leaves(layer_grads))
    return torch.sqrt(sq)


def value_and_grad(loss_fn, student, teacher, batch):
    """(loss, metrics, grads): the gradient of ``loss_fn`` in every student
    leaf, as a tree of the student's structure."""
    live = []

    def leaf(p):
        live.append(p.detach().requires_grad_(True))
        return live[-1]

    student_req = tree_map(leaf, student)
    with torch.enable_grad():
        loss, metrics = loss_fn(student_req, teacher, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(live, grads))
    return loss.detach(), metrics, tree_map(lambda _: next(it), student)


def make_train_step(model, cfg, qcfg: QuantConfig, opt: AdamW,
                    qad: QADConfig | None = None) -> Callable:
    """The training step: the loss's gradient, one AdamW update
    (``AdamW.apply``: the update added leaf by leaf)."""
    qad = qad or QADConfig()
    loss_fn = make_loss_fn(model, cfg, qcfg, qad)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, metrics, grads = value_and_grad(loss_fn, state.student,
                                              state.teacher, batch)
        with torch.no_grad():
            metrics = dict(metrics, loss=loss, grad_norm=global_norm(grads))
            if qcfg.numerics and isinstance(grads, dict) and "layers" in grads:
                num = dict(metrics.get("numerics") or {})
                num["layers.grad"] = {
                    "grad_norm": _layer_grad_norms(grads["layers"])}
                metrics["numerics"] = num
            # the update, leaf by leaf (it consumes ``grads``)
            student, opt_state, metrics["update_norm"] = opt.apply(
                grads, state.opt_state, state.student, state.step)
        return TrainState(step=state.step + 1, student=student,
                          teacher=state.teacher, opt_state=opt_state), metrics

    return step


def make_eval_step(model, cfg, qcfg: QuantConfig,
                   qad: QADConfig | None = None) -> Callable:
    """Validation step: KL against the teacher and CE against the labels
    (paper Table 1), with top-1 agreement."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> dict:
        mask = batch["mask"].to(torch.float32)
        s_logits = model.apply(cfg, state.student, batch, qcfg)
        out = {"ce": losses.ce_from_logits(s_logits, batch["labels"], mask)}
        if state.teacher is not None:
            t_logits = model.apply(cfg, state.teacher, batch, BF16)
            out["kl"] = _flat_kl(t_logits, s_logits, mask)
            out["top1_agree"] = losses.top1_agreement(t_logits, s_logits, mask)
        return out

    return eval_step
