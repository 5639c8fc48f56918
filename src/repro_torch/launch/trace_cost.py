"""Per-device cost of one step, counted while the step runs on tensors
with no data.

Counterpart of ``repro.launch.hlo_analysis``.  The reference parses the
HLO text that XLA compiles for one device and recovers the trip counts of
its ``while`` loops, since XLA's own cost analysis counts a scanned body
once.  PyTorch has no HLO, and an eager step unrolls its Python loops (one
call a layer, a microbatch, a query chunk), so there is no trip count to
recover: every operation the step issues is seen once per issue.  So this
is no parser.  :class:`CostMode` is a ``TorchDispatchMode`` entered under
a ``FakeTensorMode`` on one rank (rank 0) of a fake process group
(``launch.mesh.fake_process_group``); it watches every aten and c10d
operation of the step and adds up, for that rank:

  flops       -- products only, as the reference counts ``dot``s:
                 ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
                 baddbmm, convolutions) by the product's input dtype, plus
                 the work of every attention kernel call, which reaches the
                 kernels' shape-only route (``kernels.ops``) and is counted
                 by ``attention.flash_work`` / ``paged_work``.
  hbm_bytes   -- operand and output bytes of every aten operation that
                 launches work; views, ``detach``, metadata and factory
                 operations are skipped (the reference's ``_SKIP_OPS``).
                 Eager PyTorch fuses nothing, so every operation reads and
                 writes device memory: this is the port's own traffic, not
                 a bound borrowed from XLA's fusion.  Kernel calls add
                 their own bytes.
  coll_bytes  -- wire bytes of the c10d collectives (the Sharder's sums,
                 gathers and ``enter``s, the parameter gathers and gradient
                 sums, the optimizer's norm), with each group's size and
                 the reference's ring multipliers: all-gather
                 ``out (n-1)/n``, all-reduce ``2 out (n-1)/n``,
                 reduce-scatter ``in (n-1)/n``; split by kind and by link
                 (``nvlink`` where every rank of the group sits on one
                 host of :data:`HOST_RANKS` consecutive ranks, else ``ib``).
  peak_bytes  -- the most bytes live at once: each storage counted once,
                 from the operation that allocates it to the release of
                 its last reference, starting from the arguments' local
                 shards (``argument_bytes``).
  launches    -- the kernel calls by entry point, and ``aten_ops``, the
                 operations counted in ``hbm_bytes``; ``kernel_work``, each
                 entry point's operations and bytes in all.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import ops

HOST_RANKS = 8         # ranks a host holds: one DGX H100's eight cards

# the c10d operations the port issues (``dist.all_gather``, ``all_reduce``,
# ``broadcast``) and the reference's other kinds; any other c10d operation,
# and every functional one (``_c10d_functional``, which DTensor's
# redistributions issue), is refused rather than left uncounted
_COLL_KIND = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allreduce_": "all-reduce", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "broadcast_": "broadcast",
}
# operations that allocate and fill, launching no work on their inputs
_FACTORY = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "zeros", "zeros_like", "ones", "ones_like",
            "full", "full_like", "new_zeros", "new_ones", "new_full",
            "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
            "randn", "rand", "randint"}
_METADATA = {"sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
             "is_same_size", "_local_scalar_dense", "detach", "alias"}
# operations that write their first argument without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_"}


@dataclasses.dataclass
class TraceCost:
    flops: float
    flops_by_dtype: Dict[str, float]
    hbm_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, float]
    coll_by_link: Dict[str, float]
    coll_count: int
    peak_bytes: int
    argument_bytes: int
    launches: Dict[str, int]
    kernel_work: Dict[str, list]   # [operations, bytes] by kernel

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_of(args) -> Any:
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a)
    raise ValueError("a collective without a process group")


def _link(pg) -> str:
    ranks = dist.get_process_group_ranks(pg)
    return "nvlink" if len({r // HOST_RANKS for r in ranks}) == 1 else "ib"


class CostMode(TorchDispatchMode):
    """Counts the cost of everything run under it (see the module's
    docstring); ``args`` are the step's arguments, live from the start.
    :meth:`result` returns the :class:`TraceCost`."""

    def __init__(self, args: Iterable = ()):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)
        self.hbm = 0.0
        self.coll: Dict[str, float] = defaultdict(float)
        self.link: Dict[str, float] = defaultdict(float)
        self.coll_count = 0
        self.launches: Dict[str, int] = defaultdict(int)
        self.kernel_work: Dict[str, list] = defaultdict(lambda: [0, 0])
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        for t in _tensors(args):
            self._track(_local(t))
        self.argument_bytes = self.live_bytes

    # ---------------------------------------------------------- memory
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # ---------------------------------------------------------- kernels
    def _kernel(self, name: str, flops: int, nbytes: int,
                dtype: torch.dtype) -> None:
        self.flops[str(dtype).split(".")[-1]] += flops
        self.hbm += nbytes
        self.launches[name] += 1
        self.kernel_work[name][0] += flops
        self.kernel_work[name][1] += nbytes

    def __enter__(self):
        ops.WORK_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.WORK_SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns, name = func.namespace, func.__name__.split(".")[0]
        if ns.startswith("_c10d"):      # functional collectives (DTensor's)
            raise ValueError(f"a collective the cost model does not count: "
                             f"{ns}.{name}")
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._track(_local(t))
        if ns == "c10d":
            self._collective(name, args)
        elif ns == "aten" and not func.is_view and name not in _METADATA \
                and name not in _FACTORY \
                and _tensors((args, kwargs)):
            self._aten(func, name, args, kwargs, out)
        return out

    def _aten(self, func, name: str, args, kwargs, out) -> None:
        ins = [_local(t) for t in _tensors((args, kwargs))]
        seen, nbytes = set(), 0
        for i, t in enumerate(ins):
            if id(t) in seen or (i == 0 and name in _WRITE_ONLY):
                continue
            seen.add(id(t))
            nbytes += _nbytes(t)
        self.hbm += nbytes + sum(_nbytes(_local(t)) for t in _tensors(out))
        self.launches["aten_ops"] += 1
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            mats = [t for t in ins if t.dim() >= 2]
            dtype = (mats[0] if mats else ins[0]).dtype
            self.flops[str(dtype).split(".")[-1]] += count(
                *args, **kwargs, out_val=out)

    def _collective(self, name: str, args) -> None:
        kind = _COLL_KIND.get(name)
        if kind is None:
            raise ValueError(f"a collective the cost model does not count: "
                             f"c10d.{name}")
        pg = _group_of(args)
        n = pg.size()
        frac = (n - 1) / max(n, 1)
        tensors = _tensors(args)
        if kind == "all-gather":        # (outputs, inputs, ...)
            b = sum(_nbytes(t) for t in _tensors(args[0])) * frac
        elif kind == "reduce-scatter":  # (outputs, inputs, ...)
            b = sum(_nbytes(t) for t in _tensors(args[1])) * frac
        elif kind == "all-reduce":
            b = 2 * sum(_nbytes(t) for t in tensors) * frac
        else:
            b = sum(_nbytes(t) for t in _tensors(args[0])) * (
                frac if kind == "all-to-all" else 1.0)
        self.coll[kind] += b
        self.link[_link(pg)] += b
        self.coll_count += 1

    # ---------------------------------------------------------- result
    def result(self) -> TraceCost:
        return TraceCost(
            flops=float(sum(self.flops.values())),
            flops_by_dtype=dict(self.flops), hbm_bytes=self.hbm,
            coll_bytes=float(sum(self.coll.values())),
            coll_by_kind=dict(self.coll), coll_by_link=dict(self.link),
            coll_count=self.coll_count, peak_bytes=self.peak_bytes,
            argument_bytes=self.argument_bytes,
            launches=dict(self.launches),
            kernel_work={k: list(v) for k, v in self.kernel_work.items()})


def trace(fn, args, fake_mode) -> TraceCost:
    """The cost of ``fn`` run once on ``args`` (fake tensors of
    ``fake_mode``) under a :class:`CostMode`, its outputs live at the
    end."""
    with fake_mode, CostMode(args) as mode:
        out = fn(*args)
        cost = mode.result()
    del out
    return cost
