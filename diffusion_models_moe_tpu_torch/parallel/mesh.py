"""The ("dp", "tp") mesh, the sharding plans and the tensor-parallel layers
(PyTorch port of `diffusion_models_moe_tpu/parallel/mesh.py`).

JAX runs one program over global arrays and GSPMD places them by
`NamedSharding`. Here every process runs the same program on its own
device (SPMD over processes), with the same global inputs:

  dp: each rank takes its slice of the batch (`batch_slice`, `shard_batch`)
      and the results are all-gathered (`gather_batch`);
  tp: Megatron-style tensor parallelism. A column-parallel linear
      (`ColumnParallelLinear`) holds the rank's rows of the torch weight
      (out, in) and gives the rank's slice of the output features; a
      row-parallel one (`RowParallelLinear`) holds the rank's columns,
      all-reduces its partial product over tp and adds its bias once,
      after the reduce. Attention takes heads / tp heads a rank.

Parameters stay plain local tensors, each holding the rank's shard, so the
hand-written kernels see plain contiguous tensors. Collectives go through
two autograd functions: `copy_to_tp` (identity; its backward all-reduces)
and `reduce_from_tp` (all-reduce, added in f32; its backward is the
identity).

Plans are {parameter name: spec}, a spec one entry per tensor dimension (a
mesh axis name or None; `()` replicated), in the port's layout: torch's
weight (out, in) is JAX's kernel (in, out) transposed, so JAX's column shard
P(None, "tp") is ("tp", None) here, a row slice. The rule tables are JAX's
(`_UNET_RULES`, `_LLAMA_RULES`) over the port's diffusers / transformers
names. As in JAX, the GEGLU `proj` stays replicated and only the FF's output
projection is row-parallel, and a column-parallel layer's bias is sharded
only where JAX shards it (Llama's q/k/v); elsewhere (CLIP's fc1, PixArt's
q/k/v) the full bias is kept and the rank's slice taken at use.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

Spec = tuple          # one mesh axis name or None per dimension; () replicated


# --------------------------------------------------------------------- mesh
def mesh_shape(n: int, dp: Optional[int] = None,
               tp: Optional[int] = None) -> tuple[int, int]:
    """(dp, tp) for n devices by JAX's rule: with neither given, tp is the
    first of 4 and 2 that divides n (1 if neither) and dp = n // tp; with
    one given, the other is n // it. Raises where dp * tp != n."""
    if dp is None and tp is None:
        tp = next((c for c in (4, 2) if n % c == 0), 1)
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp {dp} x tp {tp} != {n} devices")
    return dp, tp


def mesh_shape_3d(n: int) -> tuple[int, int, int]:
    """(dp, ep, tp) by JAX's `create_mesh_3d`: a factor 2 for dp and for ep
    where it divides what is left, the rest to tp."""
    dims, rem = [], n
    for _ in range(2):
        f = 2 if rem % 2 == 0 and rem > 1 else 1
        dims.append(f)
        rem //= f
    return dims[0], dims[1], rem


class Mesh:
    """A mesh of processes: `shape` {axis: size} in axis order (row-major
    over the ranks, as JAX reshapes its device list), this process's
    coordinate on each axis, and a process group per axis (None for an axis
    of size 1, whose collectives are no-ops)."""

    def __init__(self, shape: dict, coords: dict, groups: dict):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self._groups = groups

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of `axis`, None where its size is 1."""
        return self._groups.get(axis) if self.axis_size(axis) > 1 else None

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, coords={self.coords})"


def coords_of(rank: int, shape: dict) -> dict:
    """The coordinates of `rank` on a row-major mesh of `shape`."""
    out = {}
    for axis, size in reversed(list(shape.items())):
        out[axis] = rank % size
        rank //= size
    return {a: out[a] for a in shape}


def _build_mesh(shape: dict) -> Mesh:
    n = 1
    for s in shape.values():
        n *= s
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} devices needs a process group: "
                             "call parallel.distributed.init_multihost first")
        return Mesh(shape, {a: 0 for a in shape}, {})
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a group of {world} "
                         "processes")
    from torch.distributed.device_mesh import init_device_mesh
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(dev_type, tuple(shape.values()),
                          mesh_dim_names=tuple(shape))
    groups = {a: dm.get_group(a) for a in shape}
    return Mesh(shape, coords_of(dist.get_rank(), shape), groups)


def create_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
                tp: Optional[int] = None) -> Mesh:
    """The ("dp", "tp") mesh over the process group (one device a process;
    `n_devices` defaults to the world size, 1 without a group)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    d, t = mesh_shape(n, dp, tp)
    return _build_mesh({"dp": d, "tp": t})


def create_mesh_3d(n_devices: Optional[int] = None) -> Mesh:
    """The ("dp", "ep", "tp") mesh of JAX's expert-parallel layout."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    d, e, t = mesh_shape_3d(n)
    return _build_mesh({"dp": d, "ep": e, "tp": t})


# -------------------------------------------------------------------- plans
# (regex on a state-dict name) -> spec, JAX's _UNET_RULES in the port's names
# and layout. GEGLU's proj (2H, C) stays replicated: a row split of the
# concatenated axis would put the hidden half and the gate half on
# different ranks; the output projection still gives a row-parallel FF.
_UNET_RULES = [
    (r".*\.ff\.net\.0\.proj\.weight$", (None, None)),
    (r".*\.ff\.net\.0\.proj\.bias$", (None,)),
    (r".*\.ff\.net\.2\.weight$", (None, "tp")),         # contract over tp
    (r".*\.attn\d\.to_[qkv]\.weight$", ("tp", None)),   # heads
    (r".*\.attn\d\.to_out\.0\.weight$", (None, "tp")),
    (r"(.*\.)?fc1\.weight$", ("tp", None)),             # CLIP MLP
    (r".*\.mlp\.fc2\.weight$", (None, "tp")),
    # T5 encoder (PixArt's conditioning): heads and the gated hidden over tp
    (r".*\.SelfAttention\.[qkv]\.weight$", ("tp", None)),
    (r".*\.SelfAttention\.o\.weight$", (None, "tp")),
    (r".*\.wi_[01]\.weight$", ("tp", None)),
    (r".*\.wo\.weight$", (None, "tp")),
]

# JAX's _LLAMA_RULES: column-parallel q/k/v (with their biases) and
# gate/up, row-parallel o_proj/down_proj, lm_head over the vocabulary.
# Constraint: num_kv_heads % tp == 0.
_LLAMA_RULES = [
    (r".*\.self_attn\.[qkv]_proj\.weight$", ("tp", None)),
    (r".*\.self_attn\.[qkv]_proj\.bias$", ("tp",)),
    (r".*\.self_attn\.o_proj\.weight$", (None, "tp")),
    (r".*\.(gate_proj|up_proj)\.weight$", ("tp", None)),
    (r".*\.down_proj\.weight$", (None, "tp")),
    (r"(.*\.)?lm_head\.weight$", ("tp", None)),
]


def _names(params) -> list[str]:
    if isinstance(params, nn.Module):
        return [n for n, _ in params.named_parameters()]
    return list(params)


def _plan(params, rules) -> dict[str, Spec]:
    out = {}
    for name in _names(params):
        out[name] = next((spec for pat, spec in rules if re.match(pat, name)),
                         ())
    return out


def param_shardings(params) -> dict[str, Spec]:
    """{name: spec} for a UNet, CLIP text, T5, VAE or DiT module (or its
    parameter names) by `_UNET_RULES`; unmatched names are replicated."""
    return _plan(params, _UNET_RULES)


def llama_param_shardings(params) -> dict[str, Spec]:
    """{name: spec} for a `LlamaModel` (a VLM's `language_model`) by
    `_LLAMA_RULES`: the embedding table and the norms replicated."""
    return _plan(params, _LLAMA_RULES)


def state_shardings(state, plan: dict) -> dict:
    """Specs for a `training.train.TrainState`: every name-keyed table of
    the state (masters, EMA, moments, the accumulation) follows the
    parameters' `plan`; the counters are replicated."""
    def specs(table):
        return None if table is None else {n: plan[n] for n in table}
    opt = {k: (specs(v) if isinstance(v, dict) or v is None else ())
           for k, v in state.opt_state.items()}
    return {"step": (), "params": specs(state.params), "opt_state": opt,
            "ema_params": specs(state.ema_params)}


def moe_intervention_shardings(ivs: Sequence) -> list:
    """For each layer's `LayerIntervention` (or None): {field: spec}, the
    (E, H) expert patterns' rows over "ep", every other tensor replicated."""
    out = []
    for iv in ivs:
        if iv is None:
            out.append(None)
            continue
        specs = {}
        for f in dataclasses.fields(iv):
            v = getattr(iv, f.name)
            if isinstance(v, torch.Tensor):
                specs[f.name] = (("ep", None) if f.name == "patterns"
                                 and v.dim() == 2 else ())
        out.append(specs)
    return out


def batch_sharding(ndim: int) -> Spec:
    """The leading (batch) axis over "dp"."""
    return ("dp",) + (None,) * (ndim - 1)


def replicated() -> Spec:
    return ()


# ------------------------------------------------------------------ shards
def shard_bounds(n: int, parts: int, index: int) -> slice:
    """Part `index` of `parts` equal parts of range(n); raises where parts
    does not divide n."""
    if n % parts:
        raise ValueError(f"{n} does not split into {parts} equal shards")
    k = n // parts
    return slice(index * k, (index + 1) * k)


def local_shard(t: torch.Tensor, spec: Spec, shape: dict,
                coords: dict) -> torch.Tensor:
    """The shard of `t` that the device at `coords` of a mesh of `shape`
    holds under `spec` (a view)."""
    idx = []
    for dim, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
        else:
            idx.append(shard_bounds(t.shape[dim], shape[axis], coords[axis]))
    return t[tuple(idx)]


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of `t` under `spec`, contiguous."""
    return local_shard(t, spec, mesh.shape, mesh.coords).contiguous()


def gather_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from each rank's shard `t` under `spec`: an
    all-gather over each sharded axis (every rank gets it)."""
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.group(axis) is not None:
            t = all_gather_cat(t, mesh.group(axis), dim)
    return t


def all_gather_list(t: torch.Tensor, group) -> list:
    """The group's tensors of `t`'s shape, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in rank order."""
    return t if group is None else torch.cat(all_gather_list(t, group), dim)


def all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """In place over `group` (sum unless `op`); a no-op without a group."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                        group=group)
    return t


def batch_slice(mesh: Optional[Mesh], b: int) -> slice:
    """This rank's rows of a batch of `b` over "dp"; ValueError where dp
    does not divide b."""
    if mesh is None:
        return slice(0, b)
    dp = mesh.axis_size("dp")
    if b % dp:
        raise ValueError(f"a batch of {b} does not split over dp = {dp}")
    return shard_bounds(b, dp, mesh.rank("dp"))


def shard_batch(x, mesh: Optional[Mesh]):
    """This rank's rows of `x` (a tensor or a sequence) over "dp"."""
    return x if mesh is None else x[batch_slice(mesh, len(x))]


def gather_batch(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's rows of `x`, in rank order over "dp"."""
    return x if mesh is None else all_gather_cat(x, mesh.group("dp"), 0)


# --------------------------------------------------------- tp collectives
def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of `x`, added in f32 and rounded once to x's dtype
    (a new tensor)."""
    out = x.float().contiguous()
    out = out.clone() if out is x else out
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    """Identity; the backward all-reduces the gradient over tp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce over tp; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a tp-split computation: itself; its gradient summed
    over the group."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's partial results, added in f32."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, group)
    return _sum_over(x, group)


def vocab_argmax(logits: torch.Tensor, offset: int, group) -> torch.Tensor:
    """argmax over a vocabulary split over tp, each rank holding the logits
    of its columns from `offset` on: each rank's (max, index) all-gathered,
    ties to the lowest global index (as `argmax` breaks them), NaN taken as
    the largest value (as `argmax` takes it)."""
    val, idx = logits.max(dim=-1)
    if group is None:
        return idx
    vals = torch.stack(all_gather_list(val.float(), group))
    idxs = torch.stack(all_gather_list(idx + offset, group))
    key = torch.where(torch.isnan(vals), torch.full_like(vals, float("inf")),
                      vals)
    first = (key == key.max(dim=0, keepdim=True).values).int().argmax(dim=0)
    return idxs.gather(0, first[None])[0]


# ------------------------------------------------------------- tp layers
class ColumnParallelLinear(nn.Linear):
    """The rank's rows `out_slice` of an `nn.Linear` (out, in): the rank's
    output features. The bias is the rank's slice where `bias_sharded`,
    else the whole bias, sliced at use."""

    def __init__(self, src: nn.Linear, mesh: Mesh, bias_sharded: bool):
        nn.Module.__init__(self)
        tp, r = mesh.axis_size("tp"), mesh.rank("tp")
        self.group = mesh.group("tp")
        self.in_features = src.in_features
        self.out_slice = shard_bounds(src.out_features, tp, r)
        self.out_features = self.out_slice.stop - self.out_slice.start
        self.bias_sharded = bias_sharded
        self.weight = _param(src.weight, src.weight.detach()[self.out_slice])
        b = src.bias
        self.bias = (None if b is None else _param(
            b, b.detach()[self.out_slice] if bias_sharded else b.detach()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_tp(x, self.group)
        b = self.bias
        if b is not None and not self.bias_sharded:
            b = copy_to_tp(b, self.group)[self.out_slice]
        return F.linear(x, self.weight, b)


class RowParallelLinear(nn.Linear):
    """The rank's columns `in_slice` of an `nn.Linear` (out, in): takes the
    rank's slice of the input features, all-reduces the partial product over
    tp and adds the (whole) bias once, after the reduce."""

    def __init__(self, src: nn.Linear, mesh: Mesh):
        nn.Module.__init__(self)
        tp, r = mesh.axis_size("tp"), mesh.rank("tp")
        self.group = mesh.group("tp")
        self.out_features = src.out_features
        self.in_slice = shard_bounds(src.in_features, tp, r)
        self.in_features = self.in_slice.stop - self.in_slice.start
        self.weight = _param(src.weight,
                             src.weight.detach()[:, self.in_slice])
        self.bias = None if src.bias is None else _param(src.bias,
                                                         src.bias.detach())

    def forward(self, x: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`weight` (the rank's columns) in place of the layer's own, e.g.
        under an output-weight mask."""
        y = reduce_from_tp(F.linear(x, self.weight if weight is None
                                    else weight), self.group)
        return y if self.bias is None else y + self.bias


def _param(src: nn.Parameter, value: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(value.contiguous().clone(),
                        requires_grad=src.requires_grad)


def tp_group(layer: nn.Module):
    """The tp group of a tensor-parallel layer, else None."""
    return getattr(layer, "group", None)


def in_slice(layer: nn.Module) -> slice:
    """The rank's input features of a row-parallel layer; all of them
    otherwise."""
    return getattr(layer, "in_slice", slice(None))


def linear_out(layer: nn.Linear, x: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """`layer` on `x` with `weight` in place of its own."""
    if isinstance(layer, RowParallelLinear):
        return layer(x, weight)
    return F.linear(x, weight, layer.bias)


# --------------------------------------------------------------- appliers
def shard_module(module: nn.Module, plan: dict, mesh: Mesh) -> nn.Module:
    """Shards `module` in place over the mesh's tp axis by `plan`: every
    `nn.Linear` whose weight is ("tp", None) becomes a
    `ColumnParallelLinear`, (None, "tp") a `RowParallelLinear`, each on the
    rank's slice; submodules with a `tp_shard(tp, rank)` method take their
    heads / tp (or refuse the split). A no-op where tp is 1 or the module
    is already sharded over this mesh. Raises on a sharded parameter it
    cannot place and on a layer type the split does not take (int8)."""
    tp = mesh.axis_size("tp")
    if tp == 1 or getattr(module, "_tp_mesh", None) is mesh:
        return module
    if getattr(module, "_tp_mesh", None) is not None:
        raise ValueError("module is already sharded over another mesh")
    for m in module.modules():
        hook = getattr(m, "tp_shard", None)
        if hook is not None:
            hook(tp, mesh.rank("tp"))
    placed = set()
    for name, sub in list(module.named_modules()):
        if not isinstance(sub, nn.Linear):
            continue
        wname = f"{name}.weight" if name else "weight"
        spec = plan.get(wname, ())
        if "tp" not in spec:
            continue
        if type(sub) is not nn.Linear:
            raise ValueError(f"{name}: {type(sub).__name__} is not taken "
                             "under tp > 1")
        if spec == ("tp", None):
            bname = f"{name}.bias" if name else "bias"
            new = ColumnParallelLinear(sub, mesh,
                                       "tp" in plan.get(bname, ()))
            placed.add(bname)
        elif spec == (None, "tp"):
            new = RowParallelLinear(sub, mesh)
        else:
            raise ValueError(f"{wname}: spec {spec} is not a linear's split")
        placed.add(wname)
        parent, _, attr = name.rpartition(".")
        setattr(module.get_submodule(parent), attr, new)
    stray = [n for n, s in plan.items() if "tp" in s and n not in placed]
    if stray:
        raise ValueError(f"sharded parameters with no tp layer: {stray}")
    module._tp_mesh = mesh
    return module


def shard_pipeline(pipe, mesh: Optional[Mesh]):
    """Shards every module of a pipeline (`pipe.modules()`) by
    `param_shardings` over the mesh's tp axis, in place; see
    `shard_module`."""
    if mesh is not None and mesh.axis_size("tp") > 1:
        for m in pipe.modules().values():
            shard_module(m, param_shardings(m), mesh)
    return pipe


def shard_llama(lm: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """A VLM judge's language model tensor-parallel by
    `llama_param_shardings` (JAX `benchmarks/vqa.py:_shard_judge`); the
    vision tower and the projector stay replicated."""
    if mesh is not None:
        shard_module(lm, llama_param_shardings(lm), mesh)
    return lm

