"""Learned scoring policy: a two-tower scorer trained to imitate (or
improve on) the heuristic policies (counterpart of
kubernetes_scheduler_tpu/models/learned.py).

The heuristic score is a fixed formula of two utilization series; the
learned scorer reads the full feature set the advisor collects (CPU,
memory, disk IO, both network directions) plus the resource-fit state.
Two towers (pod MLP, node MLP) meet in one [p, d] x [d, n] product, so
scoring P pods on N nodes is one batched contraction.

The arithmetic is the reference's as flax runs it, not as its docstring
reads: each tower rounds its input features through bfloat16 and back,
then every Dense layer and the score product run in float32 (flax
promotes the bf16 input against float32 parameters); GELU is the tanh
approximation; the 1/sqrt(d_model) scale is rounded to bfloat16 before it
multiplies the float32 product; the bias is a Dense(1) over the
bf16-rounded node features. On a card the products must not run in TF32
(torch.backends.cuda.matmul.allow_tf32 stays False, PyTorch's default).

Layers carry the flax module names (`pod_tower.Dense_0..2`,
`node_tower.Dense_0..2`, `node_bias`), so a reference parameter tree maps
one to one onto the state dict (convert.learned_from_reference).
Checkpoints are the port's own format (torch.save of the params, the
optimizer state and the step), not orbax.

On a dp x node mesh (sharded_train_step) the pod axis is data-parallel
over `dp` and the node axis shards over `node`, parameters replicated:
the counterpart of the reference's train_step jitted over sharded
inputs, with the collectives its GSPMD program inserts written out.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from kubernetes_scheduler_tpu_torch.device import resolve_device
from kubernetes_scheduler_tpu_torch.engine import (
    PodBatch,
    SnapshotArrays,
    _UniformDeviceCache,
    compute_feasibility,
    finish_cycle,
    normalize_scores,
    run_windows_scan,
)
from kubernetes_scheduler_tpu_torch.host.engine_surface import EngineSurface
from kubernetes_scheduler_tpu_torch.ops.stats import CPU_DIVISOR, DISK_IO_DIVISOR

POD_FEATURES = 6
NODE_FEATURES = 8

# optax.adamw's defaults (torch's AdamW decays by 1e-2 unless told)
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4

CHECKPOINT_FILE = "state.pt"


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d with d a device tensor: CUDA divides by a host scalar through
    its reciprocal, which rounds differently from the CPU's division."""
    return x / x.new_full((), d)


def make_features(
    snapshot: SnapshotArrays, pods: PodBatch
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pod_x [p, POD_FEATURES], node_x [n, NODE_FEATURES]) float32, in
    roughly [0, 1]: the reference's features and divisors."""
    r = snapshot.allocatable
    free_frac = (r - snapshot.requested) / torch.clamp(r, min=1.0)          # [n, r]
    node_x = torch.cat(
        [
            _div(snapshot.cpu_pct[:, None], CPU_DIVISOR),
            _div(snapshot.mem_pct[:, None], 100.0),
            _div(snapshot.disk_io[:, None], DISK_IO_DIVISOR),
            _div(snapshot.net_up[:, None], 100.0),
            _div(snapshot.net_down[:, None], 100.0),
            free_frac[:, :3],
        ],
        dim=1,
    )
    req = pods.request
    pod_x = torch.cat(
        [
            _div(req[:, 0:1], 32000.0),            # cpu milli vs largest node
            _div(req[:, 1:2], 64.0 * 2**30),       # memory vs largest node
            _div(req[:, 2:3], 110.0),              # pod-slot demand
            _div(pods.r_io[:, None], DISK_IO_DIVISOR),
            _div(pods.priority[:, None].to(torch.float32), 10.0),
            _div(pods.want_number[:, None].to(torch.float32), 8.0),
        ],
        dim=1,
    )
    return pod_x, node_x


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _lecun_normal_(linear: nn.Linear, generator: torch.Generator) -> None:
    """flax's default Dense init: kernel ~ a normal truncated at +-2
    sigma with sigma = sqrt(1 / fan_in) / 0.8796..., bias zero."""
    std = math.sqrt(1.0 / linear.in_features) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        linear.bias.zero_()


class Tower(nn.Module):
    """`depth` Dense + tanh-GELU layers of `width`, then Dense(out), on
    bf16-rounded inputs (layers Dense_0 .. Dense_depth)."""

    def __init__(self, in_features: int, width: int, depth: int, out: int):
        super().__init__()
        self.depth = depth
        dims = [in_features] + [width] * depth + [out]
        for i in range(depth + 1):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _bf16_round(x)
        for i in range(self.depth):
            x = F.gelu(getattr(self, f"Dense_{i}")(x), approximate="tanh")
        return getattr(self, f"Dense_{self.depth}")(x)


class NodeScorer(nn.Module):
    """Two-tower scorer: score[p, n] = pod_emb @ node_emb^T * scale + b[n],
    scale = bf16(1 / sqrt(d_model))."""

    def __init__(self, d_model: int = 128, width: int = 256, depth: int = 2):
        super().__init__()
        self.d_model, self.width, self.depth = d_model, width, depth
        self.pod_tower = Tower(POD_FEATURES, width, depth, d_model)
        self.node_tower = Tower(NODE_FEATURES, width, depth, d_model)
        self.node_bias = nn.Linear(NODE_FEATURES, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.modules():
            if isinstance(module, nn.Linear):
                _lecun_normal_(module, generator)

    def forward(self, pod_x: torch.Tensor, node_x: torch.Tensor) -> torch.Tensor:
        pod_e = self.pod_tower(pod_x)
        node_e = self.node_tower(node_x)
        bias = self.node_bias(_bf16_round(node_x))[:, 0]
        scale = _bf16_round(
            1.0 / torch.sqrt(pod_e.new_full((), float(self.d_model)))
        )
        return (pod_e @ node_e.T) * scale + bias[None, :]


class TrainState(NamedTuple):
    """Training state. `params` maps state-dict names to the tensors the
    optimizer updates in place; `opt_state` is the optimizer's state
    dict; `step` the number of steps taken."""

    params: dict
    opt_state: dict
    step: int


def _generator(rng) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


def init_train_state(
    rng,
    *,
    model: NodeScorer | None = None,
    learning_rate: float = 1e-3,
    device=None,
) -> tuple[TrainState, NodeScorer, torch.optim.AdamW]:
    """(state, model, optimizer): fresh parameters drawn on the CPU from
    `rng` (a torch.Generator or an int seed) with flax's initializer
    (the same distribution as the reference's, not the same draws), on
    `device` (cuda by default, RuntimeError without it), and AdamW at
    optax.adamw's defaults."""
    dev = resolve_device(device)
    model = (model or NodeScorer()).cpu()
    model.reset_parameters(_generator(rng))
    model.to(dev)
    params = dict(model.named_parameters())
    tx = torch.optim.AdamW(
        list(params.values()), lr=learning_rate, betas=ADAMW_BETAS,
        eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY,
    )
    return TrainState(params, tx.state_dict(), 0), model, tx


def imitation_loss(
    model: NodeScorer,
    params: dict,
    pod_x: torch.Tensor,
    node_x: torch.Tensor,
    teacher_scores: torch.Tensor,
    node_mask: torch.Tensor,
    pod_mask: torch.Tensor,
) -> torch.Tensor:
    """Masked listwise KL to the teacher's softmax placement distribution
    plus 0.01 x MSE on raw scores (the teacher is any heuristic policy's
    raw score matrix, engine.compute_scores)."""
    pred = torch.func.functional_call(model, params, (pod_x, node_x))     # [p, n]
    return _blocked_loss(
        [(pred, teacher_scores, node_mask, pod_mask)],
        lambda zs: [torch.log_softmax(zs[0], dim=-1)], lambda xs: xs[0], pod_mask.sum(),
    )


def _blocked_loss(blocks, log_softmax, total, n_pods) -> torch.Tensor:
    """imitation_loss over blocks of the [p, n] grid: `blocks` holds each
    block's (pred, teacher, node_mask, pod_mask); `log_softmax(list)` is
    the row-wise log_softmax of the blocks' masked logits across each
    row's blocks, `total(list)` the sum of the blocks' partial sums (on
    one device), `n_pods` the number of valid pods."""
    masks, t_in, p_in = [], [], []
    for pred, teacher, node_mask, pod_mask in blocks:
        mask2 = node_mask[None, :] & pod_mask[:, None]
        neg = pred.new_full((), -1e30)
        masks.append(mask2)
        t_in.append(torch.where(mask2, teacher, neg))
        p_in.append(torch.where(mask2, pred, neg))
    t_logp, p_logp = log_softmax(t_in), log_softmax(p_in)
    kl = total([(torch.exp(t) * (t - q) * m).sum() for t, q, m in zip(t_logp, p_logp, masks)])
    mse = total([(((b[0] - b[1]) ** 2) * m).sum() for b, m in zip(blocks, masks)])
    cells = total([m.sum() for m in masks]).to(kl.dtype)
    valid = torch.clamp(n_pods.to(kl.device, kl.dtype), min=1.0)
    return kl / valid + 0.01 * (mse / torch.clamp(cells, min=1.0))


def train_step(
    state: TrainState,
    model: NodeScorer,
    tx: torch.optim.Optimizer,
    pod_x: torch.Tensor,
    node_x: torch.Tensor,
    teacher_scores: torch.Tensor,
    node_mask: torch.Tensor,
    pod_mask: torch.Tensor,
) -> tuple[TrainState, torch.Tensor]:
    """One optimizer step on imitation_loss; `tx` must be the optimizer
    over `state.params` (init_train_state's). The parameters update in
    place; returns (the new state, the loss before the step)."""
    loss = imitation_loss(
        model, state.params, pod_x, node_x, teacher_scores, node_mask, pod_mask
    )
    return _step(state, tx, loss)


def _step(state: TrainState, tx: torch.optim.Optimizer, loss: torch.Tensor):
    """Gradients of `loss` into state.params, then one step of `tx`."""
    tensors = list(state.params.values())
    grads = torch.autograd.grad(loss, tensors)
    for t, g in zip(tensors, grads):
        t.grad = g
    tx.step()
    tx.zero_grad(set_to_none=True)
    return TrainState(state.params, tx.state_dict(), state.step + 1), loss.detach()


def sharded_imitation_loss(
    model: NodeScorer,
    params: dict,
    mesh,
    pod_x: torch.Tensor,
    node_x: torch.Tensor,
    teacher_scores: torch.Tensor,
    node_mask: torch.Tensor,
    pod_mask: torch.Tensor,
) -> torch.Tensor:
    """imitation_loss over a (DP_AXIS, NODE_AXIS) mesh (parallel.mesh.Mesh):
    pods and pod_mask split over dp, nodes and node_mask over node, the
    teacher over both. Block (i, j) runs on its shard's device with a
    differentiable copy of `params` there (the tensors themselves on the
    device they live on). What crosses blocks: each pod row's max over
    node (pmax) and its sum of exponentials (psum) for the masked
    log_softmax, and the loss's partial sums, reduced on the lead. No [p,
    n] matrix is gathered. Returns the loss on the lead, differentiable
    in `params`."""
    from kubernetes_scheduler_tpu_torch.parallel.mesh import (
        DP_AXIS,
        NODE_AXIS,
        pmax,
        psum,
        reduce_lead,
    )

    if mesh.axis_names != (DP_AXIS, NODE_AXIS):
        raise ValueError(f"a training mesh has axes {(DP_AXIS, NODE_AXIS)}, not {mesh.axis_names}")
    n_dp, n_node = mesh.shape
    p, n = teacher_scores.shape
    if p % n_dp or n % n_node:
        raise ValueError(f"[{p}, {n}] does not split over the {mesh.shape} mesh")
    pb, nb = p // n_dp, n // n_node
    replicas = {}
    blocks = []
    for k, dev in enumerate(mesh.devices):
        i, j = divmod(k, n_node)
        if dev not in replicas:
            replicas[dev] = {name: t.to(dev) for name, t in params.items()}
        rows, cols = slice(i * pb, (i + 1) * pb), slice(j * nb, (j + 1) * nb)
        pred = torch.func.functional_call(
            model, replicas[dev], (pod_x[rows].to(dev), node_x[cols].to(dev)))
        blocks.append((pred, teacher_scores[rows, cols].to(dev), node_mask[cols].to(dev),
                       pod_mask[rows].to(dev)))

    def log_softmax(zs):
        # the max only shifts the exponent: no gradient flows through it
        maxima = pmax([z.detach().amax(-1) for z in zs], mesh, axes=NODE_AXIS)
        shifted = [z - m[:, None] for z, m in zip(zs, maxima)]
        sums = psum([torch.exp(x).sum(-1) for x in shifted], mesh, axes=NODE_AXIS)
        return [x - torch.log(s)[:, None] for x, s in zip(shifted, sums)]

    return _blocked_loss(blocks, log_softmax, lambda xs: reduce_lead(torch.add, xs, mesh),
                         pod_mask.sum())


def sharded_train_step(
    state: TrainState,
    model: NodeScorer,
    tx: torch.optim.Optimizer,
    mesh,
    pod_x: torch.Tensor,
    node_x: torch.Tensor,
    teacher_scores: torch.Tensor,
    node_mask: torch.Tensor,
    pod_mask: torch.Tensor,
) -> tuple[TrainState, torch.Tensor]:
    """train_step on a (DP_AXIS, NODE_AXIS) mesh, the counterpart of the
    reference's train_step jitted over a ("dp", "node") mesh:
    sharded_imitation_loss (every block's forward and backward on its
    shard's device), the parameter gradients of every replica summed onto
    the parameters on the lead (autograd carries them back through the
    copies), where `tx` steps; the next step copies the new parameters
    out again. state.params live on the mesh's lead device. Returns (the
    new state, the loss before the step), as train_step."""
    loss = sharded_imitation_loss(
        model, state.params, mesh, pod_x, node_x, teacher_scores, node_mask, pod_mask)
    return _step(state, tx, loss)


def save_checkpoint(path: str, state: TrainState) -> None:
    """Persist a TrainState as <path>/state.pt (torch.save of the params,
    the optimizer state and the step; restore_checkpoint maps them to the
    CPU, then to the target's device), written to a temporary
    directory and renamed into place, so a crash mid-save never destroys
    the last good checkpoint."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(
        {
            "params": {k: v.detach() for k, v in state.params.items()},
            "opt_state": state.opt_state,
            "step": int(state.step),
        },
        os.path.join(tmp, CHECKPOINT_FILE),
    )
    backup = f"{path}.old.{os.getpid()}"
    if os.path.exists(path):
        os.replace(path, backup)
    os.replace(tmp, path)
    if os.path.exists(backup):
        shutil.rmtree(backup)


def restore_checkpoint(path: str, like: TrainState) -> TrainState:
    """Restore a TrainState saved by save_checkpoint: the params are
    copied into `like.params` in place (on their device), so an
    optimizer over them stays bound; load `opt_state` into it to resume
    training (tx.load_state_dict)."""
    saved = torch.load(
        os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
        map_location="cpu", weights_only=True,
    )
    if set(saved["params"]) != set(like.params):
        raise ValueError(
            f"checkpoint {path} holds parameters {sorted(saved['params'])}, "
            f"expected {sorted(like.params)}"
        )
    with torch.no_grad():
        for name, t in like.params.items():
            t.copy_(saved["params"][name])
    return TrainState(like.params, saved["opt_state"], int(saved["step"]))


class LearnedEngine(EngineSurface):
    """TorchEngine-compatible engine scoring with the two-tower model, on
    one device (cuda by default; RuntimeError without it).

    The policy score matrix comes from one pod_emb @ node_emb^T product
    instead of a heuristic formula; feasibility, normalization,
    (anti)affinity and assignment are the engine's own (finish_cycle), so
    every hard and soft constraint holds identically: greedy runs K4 and
    the auction K3 on windows with affinity_aware=False. `policy` is
    accepted and ignored (this engine IS the "learned" policy), and so is
    `fused` (no kernel computes the learned score)."""

    def __init__(self, params: dict, *, model: NodeScorer | None = None, device=None):
        self.device = resolve_device(device)
        self.model = (model or NodeScorer()).to(self.device).eval()
        self.model.load_state_dict(
            {k: v.detach() for k, v in params.items()}, strict=True
        )
        self.model.requires_grad_(False)
        self.params = dict(self.model.named_parameters())
        self._consts = _UniformDeviceCache(self.device)

    def _one_cycle(self, snapshot, pods, *, assigner, normalizer, affinity_aware,
                   soft, auction_rounds, auction_price_frac, _plain):
        """Two-tower scores, then the engine's tail: the ONE pipeline both
        the single-window and the windows paths run."""
        pod_x, node_x = make_features(snapshot, pods)
        with torch.no_grad():
            raw = self.model(pod_x, node_x)
        feasible = compute_feasibility(
            snapshot, pods, include_pod_affinity=not affinity_aware
        )
        norm = normalize_scores(raw, snapshot.node_mask, normalizer)
        return finish_cycle(
            snapshot, pods, raw, norm, feasible,
            assigner=assigner, affinity_aware=affinity_aware, soft=soft,
            auction_rounds=auction_rounds, auction_price_frac=auction_price_frac,
            _plain=_plain,
        )

    def schedule_batch(
        self,
        snapshot,
        pods,
        *,
        policy: str = "learned",
        assigner: str = "greedy",
        normalizer: str = "min_max",
        fused: bool = False,
        affinity_aware: bool = True,
        soft: bool = False,
        auction_rounds: int = 1024,
        auction_price_frac: float = 1.0,
        _plain: bool = False,
    ):
        return self._one_cycle(
            self._consts.swap(snapshot), self._consts.swap(pods),
            assigner=assigner, normalizer=normalizer,
            affinity_aware=affinity_aware, soft=soft,
            auction_rounds=auction_rounds, auction_price_frac=auction_price_frac,
            _plain=_plain,
        )

    def schedule_windows(
        self,
        snapshot,
        pods_windows,
        *,
        policy: str = "learned",
        assigner: str = "greedy",
        normalizer: str = "min_max",
        fused: bool = False,
        affinity_aware: bool = True,
        soft: bool = False,
        auction_rounds: int = 1024,
        auction_price_frac: float = 1.0,
        _plain: bool = False,
    ):
        """Whole-backlog scheduling with the learned scorer: the engine's
        capacity- and affinity-carrying window loop (run_windows_scan),
        each window scored by the two-tower model against the CARRIED
        snapshot state."""

        def cycle(snap, window):
            return self._one_cycle(
                snap, window, assigner=assigner, normalizer=normalizer,
                affinity_aware=affinity_aware, soft=soft,
                auction_rounds=auction_rounds,
                auction_price_frac=auction_price_frac, _plain=_plain,
            )

        return run_windows_scan(
            self._consts.swap(snapshot), self._consts.swap(pods_windows), cycle
        )

    def close(self) -> None:
        self._consts = _UniformDeviceCache(self.device)


def load_learned_engine(
    checkpoint_path: str, *, model: NodeScorer | None = None, device=None
) -> LearnedEngine:
    """Restore a trained scorer into a ready LearnedEngine on `device`."""
    model = model or NodeScorer()
    like, model, _ = init_train_state(0, model=model, device=device)
    state = restore_checkpoint(checkpoint_path, like)
    return LearnedEngine(state.params, model=model, device=device)


def sharded_learned_score_fn(params: dict, mesh, *, model: NodeScorer | None = None):
    """The learned two-tower scorer as the sharded engine's `score_fn`
    (ShardedEngine(mesh, score_fn=...) and the factories of
    parallel.engine) on `mesh` (parallel.mesh.Mesh).

    The scorer shards along the node axis with no collective of its own:
    the node tower reads per-node features of the shard's own nodes, the
    pod tower is replicated, and the [p, n_local] product is per-shard
    work (the normalization bounds there are already global). One copy of
    the parameters per mesh device, on a mesh of any shape."""
    model = model or NodeScorer()
    scorers = {}
    for dev in mesh.devices:
        if dev not in scorers:
            m = NodeScorer(model.d_model, model.width, model.depth).to(dev).eval()
            m.load_state_dict({k: v.detach() for k, v in params.items()}, strict=True)
            scorers[dev] = m.requires_grad_(False)

    def score_fn(snapshot, pods):
        pod_x, node_x = make_features(snapshot, pods)
        with torch.no_grad():
            return scorers[snapshot.node_mask.device](pod_x, node_x)

    return score_fn


def make_sharded_learned_fn(params: dict, mesh, *, model: NodeScorer | None = None,
                            windows: bool = False, **kw):
    """The learned two-tower policy on a mesh: the program of
    parallel.engine.make_sharded_schedule_fn (or make_sharded_windows_fn
    when windows=True) with the factory's options `kw` (node_axes among
    them), scored by sharded_learned_score_fn."""
    from kubernetes_scheduler_tpu_torch.parallel.engine import (
        make_sharded_schedule_fn,
        make_sharded_windows_fn,
    )

    factory = make_sharded_windows_fn if windows else make_sharded_schedule_fn
    return factory(mesh, score_fn=sharded_learned_score_fn(params, mesh, model=model), **kw)
