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

On a data x model training mesh (``mesh``: this rank's
``distributed.ctx.Mesh``, ``rules``: a ``sharding.make_rules`` table)
the state holds this rank's stored shards (``init_state_on_mesh``,
``shard_state``; the moments stored like their parameters).  A step
takes the global batch and keeps its data rank's rows
(``sharding.batch_rows``); gathers the student's and the teacher's
shards over the data group into model tiles (ZeRO-3: between steps only
the shards live); runs the loss under ``ctx.use_mesh``, where every
masked mean is global (this rank's masked sum over the whole batch's
count, ``losses.global_denominator``) and the collectives are
differentiated; sums the tiles' gradients over the data group, each rank
keeping its shard's (``sharding.reduce_to_shards``); and updates the
shards with the clip norm and the update norm over the whole mesh, every
element counted once (``optim.adamw.ShardedNorm``).  The metrics are the
global values, the same on every rank.  The eval step takes the same
global means.  The chunked KL combines its streamed log-sum-exps over
the model group where the unembedding's vocabulary splits over it; the
numerics probes' partial sums are reduced once a step
(``obs.numerics.reduce_on_mesh``), the per-layer gradient norms among
them.  ``gather_state`` and ``shard_cutter`` move a whole ``TrainState``
in and out of a rank's shards (a checkpoint in the one-device format).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..distributed import ctx, sharding
from ..kernels import ops
from ..models import common
from ..models.common import tree_leaves, tree_map
from ..obs import numerics as obs_numerics
from ..optim.adamw import AdamW, ShardedNorm, global_norm
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


def _heads(cfg) -> tuple:
    return (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def init_state_on_mesh(model, cfg, gen: torch.Generator, opt: AdamW, mesh,
                       rules, with_teacher: bool = True) -> TrainState:
    """``init_state`` on a training mesh: every leaf drawn from ``gen`` as
    ``init_state`` draws it (leaf by leaf, one whole leaf alive at a
    time) and cut to this rank's stored shard, so the shards are slices
    of the one-device draw, bitwise."""
    specs = model.param_specs(cfg)

    def keep(path, spec, w):
        return sharding.shard_tensor(spec, w, mesh, rules, path,
                                     _heads(cfg)).clone()

    params = common.init_params(specs, gen, mesh.device, leaf_fn=keep)
    teacher = tree_map(torch.clone, params) if with_teacher else None
    return TrainState(step=torch.zeros((), dtype=torch.int32,
                                       device=mesh.device),
                      student=params, teacher=teacher,
                      opt_state=opt.init(params))


def shard_state(state: TrainState, model, cfg, mesh, rules) -> TrainState:
    """This rank's stored shards of a whole ``TrainState`` (a bridged
    reference state, or a one-device one)."""
    specs = model.param_specs(cfg)
    cut = lambda tree: tree_map(torch.clone, sharding.tree_shards(
        tree, specs, mesh, rules, _heads(cfg)))
    return TrainState(step=state.step, student=cut(state.student),
                      teacher=None if state.teacher is None
                      else cut(state.teacher),
                      opt_state=type(state.opt_state)(
                          *(cut(t) for t in state.opt_state)))


def gather_params(shards, model, cfg, mesh, rules):
    """Whole parameters on every rank from a tree of stored shards (the
    fused QKV's rows in their order)."""
    specs = model.param_specs(cfg)
    places = sharding.placements(specs, mesh.shape, rules)
    return sharding.gather_full(shards, specs, places, mesh, rules,
                                _heads(cfg))


def gather_state(state: TrainState, model, cfg, mesh, rules,
                 keep: bool = True) -> TrainState | None:
    """The whole ``TrainState`` on the host from this rank's stored shards
    (a collective: every rank calls it), leaf by leaf; None on a rank that
    does not ``keep`` it (a checkpoint is written by rank 0 alone)."""
    specs = model.param_specs(cfg)
    places = sharding.placements(specs, mesh.shape, rules)
    host = (lambda t: t.cpu()) if keep else (lambda t: None)

    def whole(tree):
        return sharding.gather_full(tree, specs, places, mesh, rules,
                                    _heads(cfg), leaf_fn=host)
    out = TrainState(step=state.step.cpu(), student=whole(state.student),
                     teacher=None if state.teacher is None
                     else whole(state.teacher),
                     opt_state=type(state.opt_state)(
                         *(whole(t) for t in state.opt_state)))
    return out if keep else None


def shard_cutter(model, cfg, mesh, rules) -> Callable:
    """``cut(path, whole)``: this rank's stored shard of one whole leaf of
    a ``TrainState`` at checkpoint path ``path`` (``("student", "layers",
    "wqkv")``, ``("opt_state", "m", ...)``; the step passes whole), for
    ``CheckpointManager.restore``."""
    specs = model.param_specs(cfg)

    def cut(path: tuple, whole: torch.Tensor) -> torch.Tensor:
        if path[0] in ("student", "teacher"):
            names = path[1:]
        elif path[0] == "opt_state":
            names = path[2:]
        else:
            return whole
        sp = specs
        for k in names:
            sp = sp[k]
        return sharding.shard_tensor(sp, whole, mesh, rules, ".".join(names),
                                     _heads(cfg)).clone()
    return cut


def _flat_kl(t_logits: torch.Tensor, s_logits: torch.Tensor,
             mask: torch.Tensor, denom=None) -> torch.Tensor:
    v = s_logits.shape[-1]
    return ops.kl_loss(t_logits.reshape(-1, v), s_logits.reshape(-1, v),
                       mask.reshape(-1), denom)


def make_loss_fn(model, cfg, qcfg: QuantConfig, qad: QADConfig):
    """``loss(student, teacher, batch) -> (loss, metrics)``; the metrics
    carry no gradient."""

    def loss_fn(student, teacher, batch):
        mask = batch["mask"].to(torch.float32)
        denom = losses.global_denominator(mask)
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
            # on a mesh whose rules put "vocab" on the model axis each rank
            # holds V/m columns of the unembedding: the log-sum-exps are
            # combined over the model group, the hidden's gradient summed
            tp = ctx.current() if w_s.shape[-1] != cfg.vocab_size else None
            kl = losses.chunked_kl_loss(h_t, w_t, ctx.copy_to_model(h_s, tp),
                                        w_s, mask, qad.loss_chunks, denom, tp)
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
            ce = losses.ce_from_logits(s_logits, batch["labels"], mask, denom)
            metrics["ce"] = ce.detach()
        else:
            with torch.no_grad():
                metrics["ce"] = losses.ce_from_logits(
                    s_logits.detach(), batch["labels"], mask, denom)
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
                kl = _flat_kl(t_in, s_in.detach(), mask, denom)
        else:
            kl = _flat_kl(t_in, s_in, mask, denom)
        metrics["kl"] = kl.detach()
        with torch.no_grad():
            metrics["top1_agree"] = losses.top1_agreement(
                t_logits, s_logits.detach(), mask, denom)
        if tape is not None:
            metrics["numerics"] = _numerics_metrics(s_aux, t_aux, mask)

        if qad.loss == "kl":                       # QAD
            return kl, metrics
        if qad.loss == "mse":                      # Table 8 ablation
            mse = losses.mse_from_logits(t_logits, s_logits, mask, denom)
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
                    qad: QADConfig | None = None, mesh=None,
                    rules=None) -> Callable:
    """The training step: the loss's gradient, one AdamW update
    (``AdamW.apply``: the update added leaf by leaf); on ``mesh`` under
    ``rules``, over this rank's shards (the module docstring)."""
    qad = qad or QADConfig()
    loss_fn = make_loss_fn(model, cfg, qcfg, qad)
    if mesh is not None:
        return _make_mesh_step(model, cfg, qcfg, opt, loss_fn, mesh, rules)

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


class _MeshPlan(NamedTuple):
    specs: Any
    places: Any                 # a ``sharding.Placement`` tree
    norm: ShardedNorm
    shape: dict                 # the mesh's {"data": D, "model": M}
    replicated: Any             # ``sharding.replicated_tree``
    columns: Any                # per-column norm weights, or None, a leaf


def _mesh_plan(model, cfg, mesh, rules) -> _MeshPlan:
    specs = model.param_specs(cfg)
    places = sharding.placements(specs, mesh.shape, rules)
    replicated = sharding.replicated_tree(specs, places, mesh.shape,
                                          _heads(cfg))

    def columns(pl, cols):
        """An MQA tile's norm weights a column: its KV columns are held by
        every model rank too."""
        if cols is None:
            return None
        n = sharding._fused_tile(_heads(cfg), mesh.shape["model"])
        w = torch.full((n,), 1.0 / sharding.replication(pl, mesh.shape),
                       dtype=torch.float32, device=mesh.device)
        w[cols] /= mesh.shape["model"]
        return w
    cols = tree_map(columns, places, replicated)
    weights = tuple(1.0 / sharding.replication(pl, mesh.shape) if c is None
                    else c for pl, c in zip(tree_leaves(places),
                                            tree_leaves(cols)))
    return _MeshPlan(specs, places, ShardedNorm(weights, ctx.world_sum),
                     dict(mesh.shape), replicated, cols)


def _stack_depth(axes: tuple) -> int:
    """How many leading stack axes a leaf has: "layers", then "inner" (an
    RG-LRU super-block's recurrent layers)."""
    n = 0
    for name in ("layers", "inner"):
        if len(axes) > n and axes[n] == name:
            n += 1
    return n


def _tile_amaxes(tiles, plan: _MeshPlan, qcfg: QuantConfig, mesh,
                 rules) -> dict:
    """The tensor amax of every quantized weight tile split over the model
    group (each layer's slice of a stacked leaf apart, each inner layer's
    of a twice-stacked one), max-reduced over the group in one
    collective: ``ctx.use_mesh``'s table, read by ``QuantConfig.q_weight``
    in the forward and its recompute."""
    tp = ctx.model_group(mesh, rules)
    if tp is None or not (qcfg.enabled and qcfg.quantize_weights):
        return {}
    keys, amaxes = [], []
    for sp, pl, t in zip(tree_leaves(plan.specs), tree_leaves(plan.places),
                         tree_leaves(tiles)):
        if pl.model_dim is None or not qcfg.quantizes(sp.kind):
            continue
        a = torch.abs(t.detach().to(torch.float32))
        depth = _stack_depth(sp.axes)
        views = [t]
        for _ in range(depth):
            views = [v[i] for v in views for i in range(v.shape[0])]
        keys += [ctx.tile_key(v) for v in views]
        amaxes.append(torch.amax(a, dim=tuple(range(depth, t.ndim)))
                      .reshape(-1) if depth else torch.amax(a)[None])
        del a
    if not keys:
        return {}
    return dict(zip(keys, tp.all_reduce(torch.cat(amaxes), "max")))


def _layer_grad_partials(grads, plan: _MeshPlan) -> torch.Tensor:
    """[n_layers] f32: this rank's share of each layer's squared gradient
    norm, every stored shard weighted by 1 / its replication (summed over
    the mesh, each element counts once; an MQA tile's KV columns by
    their own weights)."""
    out = 0
    for g, pl, c in zip(tree_leaves(grads["layers"]),
                        tree_leaves(plan.places["layers"]),
                        tree_leaves(plan.columns["layers"])):
        sq = torch.square(g.to(torch.float32))
        if c is not None:
            out = out + torch.sum((sq * c).reshape(g.shape[0], -1), -1)
        else:
            out = out + torch.sum(sq.reshape(g.shape[0], -1), -1) / \
                sharding.replication(pl, plan.shape)
    return out


def _make_mesh_step(model, cfg, qcfg, opt, loss_fn, mesh, rules) -> Callable:
    plan = _mesh_plan(model, cfg, mesh, rules)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        with torch.no_grad():
            student = sharding.gather_tiles(state.student, plan.places, mesh)
            teacher = (None if state.teacher is None else
                       sharding.gather_tiles(state.teacher, plan.places, mesh))
            amaxes = _tile_amaxes(student, plan, qcfg, mesh, rules)
        with ctx.use_mesh(mesh, rules, amaxes):
            rows = sharding.batch_rows(batch, mesh)
            loss, metrics, grads = value_and_grad(loss_fn, student, teacher,
                                                  rows)
            del student, teacher, amaxes
            with torch.no_grad():
                grads = sharding.reduce_to_shards(grads, plan.places, mesh,
                                                  plan.replicated)
                num = metrics.pop("numerics", None)
                metrics = {k: ctx.data_sum(v) for k, v in metrics.items()}
                metrics.update(loss=ctx.data_sum(loss),
                               grad_norm=global_norm(grads, plan.norm))
                if num is not None:
                    # the step's probes, reduced over the mesh at once
                    if isinstance(grads, dict) and "layers" in grads:
                        num["layers.grad"] = obs_numerics.grad_partials(
                            _layer_grad_partials(grads, plan))
                    metrics["numerics"] = obs_numerics.reduce_on_mesh(num,
                                                                      mesh)
                student, opt_state, metrics["update_norm"] = opt.apply(
                    grads, state.opt_state, state.student, state.step,
                    plan.norm)
        return TrainState(step=state.step + 1, student=student,
                          teacher=state.teacher, opt_state=opt_state), metrics

    return step


def make_eval_step(model, cfg, qcfg: QuantConfig,
                   qad: QADConfig | None = None, mesh=None,
                   rules=None) -> Callable:
    """Validation step: KL against the teacher and CE against the labels
    (paper Table 1), with top-1 agreement.  ``eval_step(state, batch)``
    takes a batch, or a list of batches and returns a list of results;
    on ``mesh``, over this rank's shards and rows, the global means, the
    tiles gathered once for a list."""
    plan = _mesh_plan(model, cfg, mesh, rules) if mesh is not None else None

    def tiles(tree):
        if plan is None or tree is None:
            return tree
        return sharding.gather_tiles(tree, plan.places, mesh)

    def one(student, teacher, batch) -> dict:
        if plan is not None:
            batch = sharding.batch_rows(batch, mesh)
        mask = batch["mask"].to(torch.float32)
        denom = losses.global_denominator(mask)
        s_logits = model.apply(cfg, student, batch, qcfg)
        out = {"ce": losses.ce_from_logits(s_logits, batch["labels"], mask,
                                           denom)}
        if teacher is not None:
            t_logits = model.apply(cfg, teacher, batch, BF16)
            out["kl"] = _flat_kl(t_logits, s_logits, mask, denom)
            out["top1_agree"] = losses.top1_agreement(t_logits, s_logits,
                                                      mask, denom)
        return {k: ctx.data_sum(v) for k, v in out.items()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        batches = batch if isinstance(batch, list) else [batch]
        student, teacher = tiles(state.student), tiles(state.teacher)
        with (ctx.use_mesh(mesh, rules,
                           _tile_amaxes(student, plan, qcfg, mesh, rules))
              if plan is not None else contextlib.nullcontext()):
            out = [one(student, teacher, b) for b in batches]
        return out if isinstance(batch, list) else out[0]

    return eval_step
