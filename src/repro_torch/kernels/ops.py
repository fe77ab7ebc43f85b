"""Dispatch by device: a CUDA tensor goes to the hand-written kernel (which
runs or raises), a CPU tensor to the plain PyTorch version.  There is no
switch that sends CUDA tensors anywhere else.

Attention under autograd goes through :class:`FlashAttention`, whose
forward is K3 writing the log-sum-exp rows and whose backward is K3b; the
RWKV-6 recurrence through :class:`WKV6`, whose forward is K4 and whose
backward is K4b (on the CPU, the plain versions of all four).

On a ``meta`` tensor (the dry run, :mod:`repro_torch.launch.dryrun`) K3,
K3b, K4 and K4b are each one ``torch.library`` custom op
(``torch.ops.repro_torch.*``) whose fake gives the outputs' shapes and
dtypes without computing them, so a traced step sees each kernel as one
region, as the reference's walkers see a ``fusedkernel`` region: its FLOPs
from a formula (:data:`REGION_FLOPS`, registered with
``torch.utils.flop_counter``) and its memory traffic as its inputs and
outputs.  A CUDA or CPU tensor goes straight to the kernel or the plain
version, without the op's dispatch."""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from . import ref as _ref
from .flash_attention import HEAD_DIMS
from .flash_attention import flash_attention as _flash_kernel
from .flash_attention import flash_attention_fwd as _flash_fwd_kernel
from .flash_attention_bwd import flash_attention_bwd as _flash_bwd_kernel
from .matadd import matadd as _matadd_kernel
from .matmul import matmul as _matmul_kernel
from .wkv6 import HEAD_SIZES as WKV6_HEAD_SIZES
from .wkv6 import wkv6 as _wkv6_kernel
from .wkv6_bwd import wkv6_bwd as _wkv6_bwd_kernel


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda or b.is_cuda:
        return _matmul_kernel(a, b)
    return _ref.matmul(a, b)


def matadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda or b.is_cuda:
        return _matadd_kernel(a, b)
    return _ref.matadd(a, b)


def _on_cuda(*ts) -> bool:
    return any(t is not None and t.is_cuda for t in ts)


def _region(name: str, schema: str, fake):
    """Makes ``fn`` the custom op ``repro_torch::name`` (``schema``, with
    ``fake`` giving its outputs' shapes) for ``meta`` tensors only: a CUDA
    or CPU tensor calls ``fn`` itself, since the op's dispatch costs more
    host time a call than the kernel's launch."""
    def wrap(fn):
        op = torch.library.custom_op(f"repro_torch::{name}", fn, mutates_args=(), schema=schema)
        op.register_fake(fake)

        def call(*args):
            return op(*args) if args[0].is_meta else fn(*args)
        return call
    return wrap


@_region("flash_attention",
         "(Tensor q, Tensor k, Tensor v, bool causal, int? kv_len, float cap) -> Tensor",
         lambda q, k, v, causal, kv_len, cap: q.new_empty(q.shape))
def _k3(q, k, v, causal, kv_len, cap):
    if _on_cuda(q, k, v):
        return _flash_kernel(q, k, v, causal=causal, kv_len=kv_len, cap=cap)
    return _ref.flash_attention(q, k, v, causal=causal, kv_len=kv_len, cap=cap)


@_region("flash_attention_fwd",
         "(Tensor q, Tensor k, Tensor v, bool causal, int? kv_len, float cap) "
         "-> (Tensor, Tensor)",
         lambda q, k, v, causal, kv_len, cap: (
             q.new_empty(q.shape), q.new_empty(q.shape[:-1], dtype=torch.float32)))
def _k3_lse(q, k, v, causal, kv_len, cap):
    if _on_cuda(q, k, v):
        return _flash_fwd_kernel(q, k, v, causal=causal, kv_len=kv_len, cap=cap)
    return _ref.flash_attention_fwd(q, k, v, causal=causal, kv_len=kv_len, cap=cap)


@_region("flash_attention_bwd",
         "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor dout, bool causal, "
         "int? kv_len, float cap) -> (Tensor, Tensor, Tensor)",
         lambda q, k, v, o, lse, dout, causal, kv_len, cap: (
             q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)))
def _k3b(q, k, v, o, lse, dout, causal, kv_len, cap):
    kw = dict(causal=causal, kv_len=kv_len, cap=cap)
    if _on_cuda(q):
        return _flash_bwd_kernel(q, k, v, o, lse, dout, **kw)
    return _ref.flash_attention_bwd(q, k, v, o, lse, dout, **kw)


@_region("wkv6", "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u) -> (Tensor, Tensor)",
         lambda r, k, v, w, u: (r.new_empty(r.shape), r.new_empty(
             (*r.shape[:2], r.shape[3], r.shape[3]), dtype=torch.float32)))
def _k4(r, k, v, w, u):
    if _on_cuda(r, k, v, w, u):
        return _wkv6_kernel(r, k, v, w, u)
    return _ref.wkv6(r, k, v, w, u)


@_region("wkv6_bwd",
         "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor do, Tensor? dstate) "
         "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
         lambda r, k, v, w, u, do, dstate: tuple(t.new_empty(t.shape) for t in (r, k, v, w, u)))
def _k4b(r, k, v, w, u, do, dstate):
    if _on_cuda(r):
        return _wkv6_bwd_kernel(r, k, v, w, u, do, dstate)
    return _ref.wkv6_bwd(r, k, v, w, u, do, dstate)


def _pairs(q_shape, k_shape) -> int:
    """Query-key pairs of an attention call, every block counted: the
    whole ``Sq x Sk`` square a head, causal or not."""
    B, H, Sq, _ = q_shape
    return B * H * Sq * k_shape[2]


# FLOPs of each kernel region from its inputs' shapes: K3 4 hd a query-key
# pair (the scores and P V), K3b 10 hd (the scores again, dP, dq, dk, dv),
# as the reference's walker counts its ``fusedkernel`` regions' dots over
# every block; K4 7 N^2 a (b, h, step) (k v^T, u k v^T + S, r (.), w S +
# k v^T), K4b 14 N^2 (the state recomputed, dr, dk, dv, dw and the state's
# gradient)
REGION_FLOPS = {
    "flash_attention": lambda q, k, *_: 4 * _pairs(q, k) * q[-1],
    "flash_attention_fwd": lambda q, k, *_: 4 * _pairs(q, k) * q[-1],
    "flash_attention_bwd": lambda q, k, *_: 10 * _pairs(q, k) * q[-1],
    "wkv6": lambda r, *_: 7 * math.prod(r) * r[-1],
    "wkv6_bwd": lambda r, *_: 14 * math.prod(r) * r[-1],
}


def _flop_formula(fn):
    def formula(*args, out_shape=None, **kwargs):
        return fn(*args)
    return formula


for _name, _fn in REGION_FLOPS.items():
    register_flop_formula(getattr(torch.ops.repro_torch, _name))(_flop_formula(_fn))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None,
                    cap: float = 0.0) -> torch.Tensor:
    """q ``(B, H, Sq, hd)`` over k, v ``(B, K, Sk, hd)``, K dividing H, each
    scaled logit capped to ``cap tanh(s / cap)`` where ``cap > 0``.  With
    grad enabled and an input that requires it, through
    :class:`FlashAttention`; otherwise the serving call, with no LSE."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, kv_len, cap)
    return _k3(q, k, v, causal, kv_len, float(cap))


class FlashAttention(torch.autograd.Function):
    """Attention with the reference's ``_flash_attend_core`` gradient: the
    forward saves (q, k, v, o, lse), the backward recomputes P from the LSE
    (FlashAttention-2).  On CUDA tensors the forward is K3 with its LSE and
    the backward K3b; on CPU tensors their plain versions.  With a logit cap
    the backward takes the cap's derivative, which the reference's
    ``fusedkernel_flash_bwd`` leaves out (ROADMAP section 3, fault 7)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_len: int | None, cap: float):
        o, lse = _k3_lse(q, k, v, causal, kv_len, float(cap))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.kv_len, ctx.cap = causal, kv_len, float(cap)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        grads = _k3b(q, k, v, o, lse, dout, ctx.causal, ctx.kv_len, ctx.cap)
        return (*grads, None, None, None)


def wkv6(r, k, v, w, u) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence -> (o ``(B, H, S, N)``, final state ``(B, H, N, N)``).
    With grad enabled and an input that requires it, through :class:`WKV6`;
    otherwise the serving call."""
    ts = (r, k, v, w, u)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return WKV6.apply(*ts)
    return _k4(*ts)


class WKV6(torch.autograd.Function):
    """The RWKV-6 recurrence with the gradient of the reference's scan: the
    forward saves r, k, v, w and u, the backward recomputes the states.  On
    CUDA tensors the forward is K4 and the backward K4b; on CPU tensors
    their plain versions.  The final state's gradient may be ``None`` (0)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        return _k4(r, k, v, w, u)

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, w, u = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        return _k4b(r, k, v, w, u, do, dstate)


KERNELS = {"matmul": _matmul_kernel, "matadd": _matadd_kernel,
           "flash_attention": _flash_kernel, "wkv6": _wkv6_kernel,
           "flash_attention_bwd": _flash_bwd_kernel, "wkv6_bwd": _wkv6_bwd_kernel}
_warm: set[torch.device] = set()  # devices warm_up has run on


def launch_counts() -> dict[str, dict[str, int]]:
    """Every kernel wrapper's launch count by path: {kernel: {path: n}}."""
    return {name: dict(k.launches_by_path) for name, k in KERNELS.items()}


def add_launches(counts: dict[str, dict[str, int]], sign: int = 1) -> None:
    """Add ``sign`` x ``counts`` (as :func:`launch_counts` gives them) to the
    wrappers' counts, the total and each path's: a CUDA graph replay runs
    the kernels its capture recorded without calling their wrappers."""
    for name, by_path in counts.items():
        kernel = KERNELS[name]
        for path, n in by_path.items():
            kernel.launches_by_path[path] += sign * n
            kernel.launches += sign * n


def warm_up(device) -> None:
    """Build and load the CUDA kernels and launch each once at a tiny shape,
    on every path: K1's ``wgmma`` path in each dtype and each operand layout
    (K-major or MN-major A and B) and its ``fma`` path; K2 ``direct`` and
    ``copy``; K3 in each dtype at each built head dim (``tma``, ``fp32``,
    and ``split`` at one query row), uncapped and with a logit cap, on a bf16
    view TMA cannot address
    (``copy``) and at a head dim that is padded (``pad``); K4 at each built
    head size (``ring``), with unequal strides (``copy``) and at a padded
    head size (``pad``); K4b likewise
    (``direct``, ``copy`` of an n-stride 2 view, ``pad``).  So the one-time
    costs (the ``nvcc`` build, loading the library and each kernel's module,
    the shared-memory settings of ``cudaFuncSetAttribute``) stay out of a
    timed run and out of a CUDA graph capture.  A no-op for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(16, 16, device=device, dtype=dtype)
        for a in (x, x.T):
            for b in (x, x.T):
                _matmul_kernel(a, b)
        y = torch.zeros(16, 15, device=device, dtype=dtype)
        _matmul_kernel(y, y.T)  # rows of 15 elements, not 16-byte multiples: fma
    x = torch.zeros(8, 8, device=device)
    _matadd_kernel(x, x)
    _matadd_kernel(x.T, x)  # not contiguous: copy
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (*HEAD_DIMS, 4):  # 4 is padded up to 32
            for sq in (8, 1):  # in bf16, 8 query rows take tma and 1 split
                a = torch.zeros(1, 1, sq, hd, device=device, dtype=dtype)
                for cap in (0.0, 1.0):
                    _flash_kernel(a, a, a, cap=cap)
    a = torch.zeros(1, 1, 8, 64, device=device, dtype=torch.bfloat16)[..., ::2]
    _flash_kernel(a, a, a)  # a strided last dimension: copy
    for n in (*WKV6_HEAD_SIZES, 4):  # 4 is padded up to 32
        u = torch.zeros(1, n, device=device)
        _wkv6_kernel(*[torch.zeros(1, 1, 8, n, device=device)] * 4, u)
    r = torch.zeros(1, 1, 8, 32, device=device)
    k = torch.zeros(1, 8, 1, 32, device=device).transpose(1, 2)  # other strides: copy
    _wkv6_kernel(r, k, r, r, torch.zeros(1, 32, device=device))
    for n in (*WKV6_HEAD_SIZES, 4):  # 4 is padded up to 32
        x = torch.zeros(1, 1, 8, n, device=device)
        _wkv6_bwd_kernel(x, x, x, x, torch.zeros(1, n, device=device), x)
    do = torch.zeros(1, 1, 8, 64, device=device)[..., ::2]  # n-stride 2: copy
    _wkv6_bwd_kernel(r, r, r, r, torch.zeros(1, 32, device=device), do)
    torch.cuda.synchronize(device)
    _warm.add(device)


def ensure_warm(device) -> None:
    """:func:`warm_up` once per device (a CUDA graph capture calls it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda" and device not in _warm:
        warm_up(device)


# ---------------------------------------------------------------------------
# Super-step chain builder
# ---------------------------------------------------------------------------

def build_chain(steps, keep=None):
    """Compose a group's intra-group kernel chain into ONE callable.

    ``steps`` is a sequence of ``(fn, srcs)`` in topological order, where each
    ``srcs`` entry names one positional argument of ``fn``:

    * ``("ext", i)`` — the i-th *external* input of the chain (a block that
      lives outside the group-step: a host seed or another group's output);
    * ``("mem", j)`` — the output of the j-th earlier step (an intra-group
      edge; it never touches host or comm lanes).

    ``keep`` selects which step outputs the chain returns (default: all).
    Outputs that are dead after the chain — every consumer is an earlier
    ``("mem", ...)`` reference — should be omitted: XLA then fuses straight
    through them instead of materializing one buffer per kernel, which is
    most of the super-step's dispatch-overhead win.

    The returned ``chain(*ext) -> tuple(kept outputs)`` is pure: the
    executor captures it into one CUDA graph per (revision, group signature,
    shapes/dtypes) on a CUDA group (:class:`repro_torch.kernels.graphs.
    CapturedChain`), so a whole partition group replays as one graph launch
    with one ready-barrier per group-step instead of one per kernel; on a
    CPU group it calls it as it is.  Each step output that is not kept is
    dropped after its last reader runs, so a capture's private memory pool
    holds the chain's live set, not every intermediate at once.
    """
    plan = [(fn, tuple(srcs)) for fn, srcs in steps]
    keep = tuple(range(len(plan))) if keep is None else tuple(keep)
    last_read = {j: j for j in range(len(plan))}
    for i, (_, srcs) in enumerate(plan):
        for kind, j in srcs:
            if kind == "mem":
                last_read[j] = i
    drop_after: list[list[int]] = [[] for _ in plan]
    for j, i in last_read.items():
        if j not in keep:
            drop_after[i].append(j)

    def chain(*ext):
        outs: list = [None] * len(plan)
        for i, (fn, srcs) in enumerate(plan):
            outs[i] = fn(*[ext[j] if kind == "ext" else outs[j] for kind, j in srcs])
            for j in drop_after[i]:
                outs[j] = None
        return tuple(outs[i] for i in keep)

    return chain
