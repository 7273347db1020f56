"""Counters of a planned step, and the roofline terms they feed.

Port of ``repro/launch/hlo_analysis.py``.  The JAX module reads XLA's
cost analysis and parses the partitioned HLO text for collectives; the
port has no compiled artifact, so :class:`StepCounter` reads the step
itself as it runs on the ``meta`` device (``api.run_abstract``): a
``TorchDispatchMode`` that lets every DTensor op go down to the ops its
shards run (it answers ``NotImplemented`` to a DTensor op, so DTensor
dispatches and the local ops come back to the mode) and counts, per
device:

* FLOPs: ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``) on each local op's shapes (the ops DTensor runs to
  plan, on fake tensors to infer a layout's shapes or inside its sharding
  propagation, are not the device's, and are left out);
* bytes: the local input and output bytes of every op that is not a view
  and not a collective (each input read once, each output written once),
  but an op that moves rows by index counts the rows it moves
  (:func:`_moved_bytes`), not the whole tensor it indexes;
* collectives: the output bytes of each functional collective
  (``_c10d_functional.*``, and DTensor's ``_dtensor.shard_dim_alltoall``),
  by kind and count — ``parse_collectives``' convention: its shapes are
  per device.

The roofline numbers are the H100's (``config.HardwareConfig``), not a
TPU's: ``t_collective`` divides by the NVLink rate, which holds inside one
8-card NVLink node; a 16-way axis spans two nodes, so there the term is a
lower bound (the inter-node link is slower).  XLA counts after fusion, so
bytes differ from the JAX dry run's by design; the shapes, the specs and
the analytic terms are what compare.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import (DetectorConfig, DiTConfig,
                                EfficientNetConfig, TransformerConfig,
                                ViTConfig)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collective op name -> its kind in the HLO vocabulary
_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",          # DTensor's own (_dtensor)
}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


#: DTensor's sharding propagation.  For an op with no strategy of its own
#: it runs the op's decomposition once for each candidate placement, on
#: ``meta`` tensors it allocates for the purpose (and on a fake mesh it
#: builds once).  That is planning, not the device's work; and how many
#: candidates it tries before one gives up depends on the order of a ``set``
#: of placements (``Partial`` hashes its reduce op's name), so counting them
#: made a cell's bytes depend on the process's string-hash seed.
_PLANNING = "propagate_op_sharding_non_cached"


def _planning() -> bool:
    """Whether the op being dispatched runs inside DTensor's sharding
    propagation (a frame of it is on the stack)."""
    frame = sys._getframe(2)
    while frame is not None:
        code = frame.f_code
        if code.co_name == _PLANNING and "distributed" in code.co_filename:
            return True
        frame = frame.f_back
    return False


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _moved_bytes(func, args, kwargs, out) -> int:
    """The bytes an op reads and writes: each input once, each output
    once; ``index_select`` reads its rows (its output's size) and the
    index, and an in-place ``index_copy_`` reads its source and the index
    and writes the source's rows into ``self`` (a decode step's cache row
    at a device position), as XLA counts a dynamic slice and its update
    by the slice."""
    if func is torch.ops.aten.index_select.default:
        return 2 * sum(_nbytes(t) for t in _tensors(out)) + _nbytes(args[2])
    if func is torch.ops.aten.index_copy_.default:
        return 2 * _nbytes(args[3]) + _nbytes(args[2])
    return (sum(_nbytes(t) for t in _tensors(args))
            + sum(_nbytes(t) for t in _tensors(kwargs))
            + sum(_nbytes(t) for t in _tensors(out)))


class StepCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes and collectives of the ops run inside it
    (see the module docstring).  On plain tensors it counts every op, so
    the same counter reads a run on the card."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll = CollectiveStats({k: 0.0 for k in _COLLECTIVES},
                                    {k: 0 for k in _COLLECTIVES})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is not torch.ops.prim.device.default:
            # a composite op (inference mode lets them through) is counted
            # by its parts, as FlopCounterMode counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        # DTensor infers some output shapes by running the op on fake
        # tensors (global shapes): that is planning, not the device's work
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in _tensors(out)):
            return out
        if _planning():
            return out
        packet = func._overloadpacket
        ns = packet._qualified_op_name.split("::")[0]
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor"):
            kind = _KIND.get(packet.__name__)
            if kind is not None:
                self.coll.bytes_by_kind[kind] += sum(
                    _nbytes(t) for t in _tensors(out))
                self.coll.count_by_kind[kind] += 1
            return out
        fn = self._flops_of.get(packet)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        if not func.is_view and any(True for _ in _tensors(out)):
            self.bytes += _moved_bytes(func, args, kwargs, out)
        return out


def local_bytes(tree) -> int:
    """The bytes one device holds of a tree of (D)Tensors."""
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


# ----------------------------------------------------------------- terms ----

@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    peak_flops: float
    hbm_bw: float
    nvlink_bw: float
    model_flops_global: float = 0.0
    chips: int = 1
    arg_bytes: int = 0
    temp_bytes: int = 0          # no counterpart in an eager run: 0
    out_bytes: int = 0
    analytic_act_bytes: float = 0.0
    notes: str = ""

    @property
    def hbm_estimate(self) -> float:
        """args (exact: params+opt+cache+batch) + analytic activations."""
        return self.arg_bytes + self.analytic_act_bytes

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / self.nvlink_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): remat/dispatch waste."""
        hlo_global = self.flops_per_device * self.chips
        if hlo_global <= 0:
            return 0.0
        return self.model_flops_global / hlo_global

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of compute peak: t_compute / max(all terms),
        i.e. how close the cell sits to being compute-bound."""
        t_max = max(self.t_compute, self.t_memory, self.t_collective, 1e-30)
        return self.t_compute / t_max

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": f"{self.t_compute:.3e}",
            "t_memory_s": f"{self.t_memory:.3e}",
            "t_collective_s": f"{self.t_collective:.3e}",
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": f"{self.useful_flops_ratio:.2f}",
            "roofline_fraction": f"{self.roofline_fraction:.2f}",
            "hbm_bytes_per_dev": f"{self.arg_bytes + self.temp_bytes:.3e}",
            "notes": self.notes,
        }


def estimate_activation_bytes(cfg, shape, kind: str, data_size: int,
                              model_size: int, accum: int = 1,
                              act_seq: bool = False) -> float:
    """Coarse analytic per-device activation footprint (remat policy:
    per-layer dot outputs saved; flash attention — scores never
    materialize), the JAX package's model term for term.  The port's
    eager meta run keeps no buffer plan, so the fits-in-memory call uses
    this model.
    """
    B = max(shape.global_batch // (accum * data_size), 1)

    if isinstance(cfg, TransformerConfig):
        d = cfg.d_model
        if cfg.moe:
            ff_active = (cfg.moe.top_k + cfg.moe.n_shared) * \
                (cfg.moe.d_ff_expert or cfg.d_ff)
        else:
            ff_active = cfg.d_ff
        ff_dev = ff_active / (1 if cfg.moe else model_size)
        if kind == "train":
            tok = B * shape.seq_len
            seq_shards = model_size if act_seq else 1
            carry = tok * d * 2 / seq_shards            # layer-boundary x
            if getattr(cfg, "remat_policy", "dots") == "minimal":
                per_layer = carry
            else:
                heads_div = cfg.n_heads % model_size == 0
                attn = tok * 2 * (2 * d / (model_size if heads_div else 1)
                                  + 2 * cfg.n_kv_heads * cfg.head_dim /
                                  (model_size if cfg.n_kv_heads %
                                   model_size == 0 else 1))
                mlp = tok * 2 * 2 * ff_dev
                per_layer = carry + attn + mlp
            logits = B * 512 * cfg.vocab / model_size * 4  # loss chunk
            # the attention transient is block-bounded (flash kernel
            # working set), not O(S^2)
            transient = 64 * 2**20
            return cfg.n_layers * per_layer + logits + transient
        if kind == "prefill":
            tok = B * shape.seq_len
            return 6 * tok * d * 2 + 64 * 2**20
        if kind == "decode":
            return 8 * B * d * 2 * cfg.n_layers
    if isinstance(cfg, (ViTConfig, DiTConfig, DetectorConfig)):
        d = cfg.d_model
        if isinstance(cfg, DiTConfig):
            tok = B * cfg.n_tokens(shape.img_res)
        elif isinstance(cfg, ViTConfig):
            side = (shape.img_res or cfg.img_res) // cfg.patch
            tok = B * (side * side + 2)
        else:
            tok = B * cfg.n_tokens
        ff_dev = getattr(cfg, "d_ff", 4 * d) / model_size
        saved = tok * 2 * (4 * d + 2 * ff_dev)
        n_live = cfg.n_layers if kind in ("train", "cls") else 2
        return n_live * saved + tok * tok // max(B, 1) * 4  # + scores
    if isinstance(cfg, EfficientNetConfig):
        r = shape.img_res or cfg.img_res
        # dominant early-stage feature maps, ~sum over stages of B*H*W*C
        total = 0.0
        res, c = r // 2, cfg.scaled_channels(cfg.stem_channels)
        for (e, ch, rep, st, k) in cfg.STAGES:
            res = res // st
            c = cfg.scaled_channels(ch)
            total += cfg.scaled_repeats(rep) * res * res * c * e * 2
        n_live = 1.0 if kind == "serve" else 1.0  # BN saves activations
        return B * total * n_live
    return 0.0


def model_flops(n_params: int, n_active: int, shape, kind: str,
                cfg=None) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (fwd-only), N = active params.

    D (tokens processed): LM = batch*seq (train/prefill) or batch (decode);
    vision/diffusion = batch * tokens; gen multiplies by sampler steps.
    """
    if kind in ("train", "cls"):
        mult = 6.0
    else:
        mult = 2.0
    if shape.seq_len:
        d = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    elif cfg is not None and callable(getattr(cfg, "n_tokens", None)):
        d = shape.global_batch * cfg.n_tokens(shape.img_res)   # DiT
    elif cfg is not None and hasattr(cfg, "patch") and shape.img_res:
        side = shape.img_res // cfg.patch                       # ViT/DeiT
        d = shape.global_batch * (side * side + 1)
    elif shape.img_res:
        d = shape.global_batch * (shape.img_res // 16) ** 2
    else:
        d = shape.global_batch
    steps = shape.steps if kind == "gen" else 1
    return mult * n_active * d * steps
