"""K8: the node-table encode, H = tanh(dropout(X) W1) W2 for every
chromosome, as one kernel launch a direction.

``models/hypersagnn.py:encode_node_table`` draws the feature-dropout
uniforms as it always has (through its module-level ``rand``: one (C, W, W)
draw for small tables, else one (n_c, n_c) draw per chromosome) and, on a
CUDA tensor of a width K8 takes (``takes``), hands the rest to
``csrc/node_encode.cu``:

  * ``Keep`` packs the keep test ``u < float32(1 - rate)`` of the rows each
    chromosome's rows read from its draw into bits (``keep_cuda``, one
    launch per run of draws held together, at most ``KEEP_GROUP_BYTES`` of
    them, so a rank of the 10 kb mesh never holds every draw at once);
  * ``node_encode`` runs the forward (``encode_fwd_cuda``) and, through an
    autograd Function, the backward (``encode_bwd_cuda``: dW1 and dW2 in
    f32 for the master weights).

A ``Plan`` is the kernel's table of every chromosome's pointers, row counts
and offsets and its lists of tiles, built once per set of tables, weights
and layout and kept on the device.  The plain version is the eager chain in
``encode_node_table`` itself, which every CPU tensor takes;
``keep_plain`` and ``node_encode_plain`` here compute the keep test and the
forward from the same layout, for the tests.  Each wrapper takes CUDA
tensors only and raises, before the library is loaded, on anything the
kernel does not take.  ``encode_fwd_cuda.launches``,
``encode_bwd_cuda.launches`` and ``keep_cuda.launches`` count launches.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

from matcha_tpu_torch.device import to_device

# a chromosome's fields in the kernel's table (csrc/node_encode.cu: F_*)
(F_X, F_W1, F_W2, F_ROWS, F_WIDTH, F_OUT, F_T, F_BITS, F_WORDS, F_UOFF,
 F_UTOP, F_USTRIDE, F_GW1, F_GW2) = range(14)
NF = 14
WIDTHS = (16, 32, 48, 64)     # the embedding widths K8 takes
MAXC = 64                     # chromosomes
TM = 64                       # rows of a tile
# the draws a rank holds before their keep bits are packed
KEEP_GROUP_BYTES = 1 << 30
_PLANS: "OrderedDict[tuple, Plan]" = OrderedDict()
_MAX_PLANS = 16


def takes(features: Sequence[torch.Tensor], dim: int) -> bool:
    """Whether K8 encodes these tables: on a CUDA tensor, at a width in
    ``WIDTHS``, with at most ``MAXC`` chromosomes (the rest take the eager
    chain)."""
    return (len(features) > 0 and features[0].device.type == "cuda"
            and dim in WIDTHS and len(features) <= MAXC)


@functools.lru_cache(maxsize=None)
def _library():
    """K8's ctypes entry points (built at first use)."""
    from matcha_tpu_torch.kernels.build import load_library
    lib = load_library("node_encode")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.matcha_node_encode_keep.argtypes = [p, i, i, p, f, p, ll, p]
    lib.matcha_node_encode_fwd.argtypes = [p, p, i, p, f, i, i, i, i, p, p,
                                           i, p]
    lib.matcha_node_encode_bwd.argtypes = [p, p, i, p, f, i, i, i, i, p, p,
                                           p, p]
    for fn in (lib.matcha_node_encode_keep, lib.matcha_node_encode_fwd,
               lib.matcha_node_encode_bwd):
        fn.restype = ctypes.c_int
    lib.matcha_cuda_error_string.argtypes = [ctypes.c_int]
    lib.matcha_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(a):
    return a.data_ptr() if isinstance(a, torch.Tensor) else a


def _call(entry: str, device: torch.device, *args) -> None:
    """Call the C entry ``entry`` with ``args`` (tensors as their pointers)
    and the current stream of ``device``; raise on a CUDA error."""
    fn = getattr(_library(), entry)
    args = [_ptr(a) for a in args] + [
        torch._C._cuda_getCurrentRawStream(device.index)]
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"node_encode kernel launch failed ({entry}): "
            f"{_library().matcha_cuda_error_string(err).decode()} "
            f"(cudaError {err})")


def _refuse(what: str, problems: List[str]) -> None:
    if problems:
        raise ValueError(f"{what}: " + "; ".join(problems))


def _exclusive(a) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(a)[:-1]]).astype(np.int64)


class Plan:
    """K8's table for one set of feature tables, weights and layout.

    fields (C, NF) int64 (csrc/node_encode.cu's F_*), the forward tiles
    (chromosome, 64-row block), widest chromosomes first, and the backward
    tiles (chromosome, 64-column block), then (chromosome, -1) for dW2, the
    tallest first; ``table`` holds all three on the device.  ``out_rows``:
    1 + the sum of the widths with row 0 zero (``whole``), else the sum of
    the rows; ``t_rows``, ``n_words`` and ``n_grad``: the rows of T, the
    keep words and the floats of the flat gradient."""

    def __init__(self, features, w1s, w2s, cdt: torch.dtype,
                 draw_widths: Sequence[int], draw_rows: Sequence[int],
                 whole: bool):
        C = len(features)
        d = int(w2s[0].shape[0])
        rows = np.array([f.shape[0] for f in features], np.int64)
        widths = np.array([f.shape[1] for f in features], np.int64)
        words = (widths + 31) // 32
        fields = np.zeros((C, NF), np.int64)
        fields[:, F_X] = [f.data_ptr() for f in features]
        fields[:, F_W1] = [w.data_ptr() for w in w1s]
        fields[:, F_W2] = [w.data_ptr() for w in w2s]
        fields[:, F_ROWS] = rows
        fields[:, F_WIDTH] = widths
        fields[:, F_OUT] = (1 + _exclusive(widths)) if whole \
            else _exclusive(rows)
        fields[:, F_T] = _exclusive(rows)
        fields[:, F_BITS] = _exclusive(rows * words)
        fields[:, F_WORDS] = words
        fields[:, F_UOFF] = draw_rows
        fields[:, F_UTOP] = np.asarray(draw_widths, np.int64) - 1
        fields[:, F_USTRIDE] = draw_widths
        fields[:, F_GW1] = _exclusive(widths * d)
        fields[:, F_GW2] = int((widths * d).sum()) + d * d * np.arange(C)
        row_tiles = (rows + TM - 1) // TM
        col_tiles = (widths + TM - 1) // TM
        fwd = [(c, t) for c in np.argsort(-widths, kind="stable")
               for t in range(int(row_tiles[c]))]
        tall = np.argsort(-rows, kind="stable")
        bwd = [(c, t) for c in tall for t in range(int(col_tiles[c]))] + [
            (c, -1) for c in tall]
        self.fields, self.d, self.cdt, self.whole = fields, d, cdt, whole
        self.x_bf16 = features[0].dtype == torch.bfloat16
        self.n_fwd, self.n_bwd = len(fwd), len(bwd)
        self.out_rows = int(1 + widths.sum()) if whole else int(rows.sum())
        self.t_rows = int(rows.sum())
        self.n_words = int((rows * words).sum())
        self.n_grad = int((widths * d).sum()) + C * d * d
        self.device = features[0].device
        self.table = to_device(np.concatenate(
            [fields.ravel(), np.asarray(fwd, np.int64).ravel(),
             np.asarray(bwd, np.int64).ravel()]), self.device)
        self.tiles_fwd = self.table[C * NF:C * NF + 2 * self.n_fwd]
        self.tiles_bwd = self.table[C * NF + 2 * self.n_fwd:]

    def grad_views(self, grad: torch.Tensor):
        """The flat gradient as (dW1 (width, d) per chromosome, dW2 (d, d)
        per chromosome) views."""
        d = self.d
        w1 = [grad[o:o + w * d].view(w, d) for o, w in
              zip(self.fields[:, F_GW1].tolist(),
                  self.fields[:, F_WIDTH].tolist())]
        w2 = [grad[o:o + d * d].view(d, d)
              for o in self.fields[:, F_GW2].tolist()]
        return w1, w2


def _layout(a: torch.Tensor) -> tuple:
    """What a plan reads of a table or weight: its pointer, shape, strides
    and dtype."""
    return a.data_ptr(), tuple(a.shape), a.stride(), a.dtype


def plan(features: Sequence[torch.Tensor], w1s: Sequence[torch.Tensor],
         w2s: Sequence[torch.Tensor], cdt: torch.dtype,
         draw_widths: Sequence[int], draw_rows: Sequence[int],
         whole: bool) -> Plan:
    """The ``Plan`` of these tables (kept while the tables' and weights'
    pointers, shapes, strides and dtypes are the same).  features: C (rows, width) tables, f32 or bf16; w1s
    (width, d) and w2s (d, d) f32; chromosome c's rows read rows
    min(draw_rows[c] + i, draw_widths[c] - 1) of its square (draw_widths[c],
    draw_widths[c]) draw; whole: the output is the node table (rows ==
    widths, row 0 zero, chromosome c at 1 + the widths before it), else
    the chromosomes' rows in order."""
    key = (features[0].device, cdt, bool(whole), int(w2s[0].shape[0]),
           tuple((_layout(f), _layout(w1), _layout(w2), int(dw), int(dr))
                 for f, w1, w2, dw, dr in zip(features, w1s, w2s,
                                              draw_widths, draw_rows)))
    p = _PLANS.get(key)
    if p is None:
        _check_plan(features, w1s, w2s, cdt, draw_widths, draw_rows, whole)
        p = _PLANS[key] = Plan(features, w1s, w2s, cdt, draw_widths,
                               draw_rows, whole)
        while len(_PLANS) > _MAX_PLANS:
            _PLANS.popitem(last=False)
    return p


def _check_plan(features, w1s, w2s, cdt, draw_widths, draw_rows,
                whole) -> None:
    """Raise ValueError naming everything of a plan's inputs the kernel
    does not take (checked once per plan: a plan is kept while its
    tables' and weights' pointers, shapes, strides and dtypes are the
    same)."""
    C = len(features)
    problems = []
    if not 1 <= C <= MAXC or len(w1s) != C or len(w2s) != C \
            or len(draw_widths) != C or len(draw_rows) != C:
        problems.append(f"takes 1 to {MAXC} chromosomes, each with its w1, "
                        f"w2 and draw layout")
        _refuse("node_encode.plan", problems)
    dev = features[0].device
    d = int(w2s[0].shape[0]) if w2s[0].dim() == 2 else -1
    if dev.type != "cuda":
        problems.append("takes CUDA tensors only (the CPU takes the eager "
                        "chain)")
    if cdt not in (torch.bfloat16, torch.float32):
        problems.append(f"the compute dtype must be bf16 or f32, not {cdt}")
    if d not in WIDTHS:
        problems.append(f"d must be one of {WIDTHS}, not {d}")
    if features[0].dtype not in (torch.float32, torch.bfloat16):
        problems.append("the feature tables must be f32 or bf16")
    for c in range(C):
        f, w1, w2 = features[c], w1s[c], w2s[c]
        if f.dim() != 2 or f.dtype != features[0].dtype \
                or f.device != dev or not f.is_contiguous() \
                or min(f.shape) < 1:
            problems.append(f"features[{c}] must be a contiguous 2-D "
                            f"{features[0].dtype} table on {dev}, got "
                            f"{f.dtype} {tuple(f.shape)} on {f.device}")
            continue
        for name, w, shape in (("w1", w1, (f.shape[1], d)),
                               ("w2", w2, (d, d))):
            if w.dtype != torch.float32 or tuple(w.shape) != shape \
                    or w.device != dev or not w.is_contiguous() \
                    or w.data_ptr() % 16:
                problems.append(f"{name}[{c}] must be contiguous f32 "
                                f"{shape} on {dev} at a 16-byte boundary, "
                                f"got {w.dtype} {tuple(w.shape)} on "
                                f"{w.device}")
        if whole and f.shape[0] != f.shape[1]:
            problems.append(f"features[{c}] must be square for the whole "
                            "node table")
        if draw_widths[c] < f.shape[1] or draw_rows[c] < 0:
            problems.append(f"chromosome {c}'s draw must be at least as "
                            "wide as its table")
    _refuse("node_encode.plan", problems)


def _threshold(rate: float) -> float:
    """The keep test's threshold as the eager chain compares it:
    float32(1 - rate)."""
    return float(np.float32(1.0 - rate))


def _scale(rate: float) -> float:
    """1 / (1 - rate) in f32, the factor the eager chain's division by a
    scalar multiplies by."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def keep_cuda(plan: Plan, c0: int, draws: Sequence[torch.Tensor],
              rate: float, bits: torch.Tensor) -> None:
    """The keep bits of chromosomes c0, c0 + 1, ... into ``bits``, from
    ``draws``: chromosome c0 + i's (m, m) draw is draws[i], an f32
    contiguous view on the plan's device (m its draw width)."""
    c1 = c0 + len(draws)
    problems = []
    if not 0 <= c0 < c1 <= len(plan.fields):
        problems.append(f"chromosomes [{c0}, {c1}) outside the plan's "
                        f"{len(plan.fields)}")
    else:
        for i, u in enumerate(draws):
            m = int(plan.fields[c0 + i, F_USTRIDE])
            if u.dtype != torch.float32 or tuple(u.shape) != (m, m) \
                    or u.device != plan.device or not u.is_contiguous():
                problems.append(f"draw {c0 + i} must be contiguous f32 "
                                f"({m}, {m}) on {plan.device}, got {u.dtype} "
                                f"{tuple(u.shape)} on {u.device}")
    if bits.dtype != torch.int32 or tuple(bits.shape) != (plan.n_words,) \
            or bits.device != plan.device:
        problems.append(f"bits must be int32 ({plan.n_words},) on "
                        f"{plan.device}")
    _refuse("keep_cuda", problems)
    f = plan.fields[c0:c1]
    ptrs = (ctypes.c_void_p * MAXC)()
    for i, u in enumerate(draws):
        ptrs[c0 + i] = u.data_ptr()
    _call("matcha_node_encode_keep", plan.device, plan.table, c0, c1,
          ctypes.cast(ptrs, ctypes.c_void_p).value, _threshold(rate), bits,
          int((f[:, F_ROWS] * f[:, F_WORDS]).sum()))
    keep_cuda.launches += 1


class Keep:
    """A step's feature-dropout draws, added in chromosome order, packed
    into the plan's keep bits once the held draws reach
    ``KEEP_GROUP_BYTES`` (and at ``finish``)."""

    def __init__(self, plan: Plan, rate: float):
        self.plan, self.rate = plan, rate
        self.bits = torch.empty((plan.n_words,), dtype=torch.int32,
                                device=plan.device)
        self.next, self.held, self.nbytes = 0, [], 0

    def add(self, u: torch.Tensor) -> None:
        """u: the next chromosome's (m, m) draw, or the (k, m, m) draws of
        the next k chromosomes."""
        views = list(u) if u.dim() == 3 else [u]
        self.held += views
        self.nbytes += u.numel() * u.element_size()
        if self.nbytes >= KEEP_GROUP_BYTES:
            self._pack()

    def _pack(self) -> None:
        if self.held:
            keep_cuda(self.plan, self.next, self.held, self.rate, self.bits)
            self.next += len(self.held)
        self.held, self.nbytes = [], 0

    def finish(self) -> torch.Tensor:
        self._pack()
        if self.next != len(self.plan.fields):
            raise ValueError(f"Keep: {self.next} of "
                             f"{len(self.plan.fields)} chromosomes drawn")
        return self.bits


def encode_fwd_cuda(plan: Plan, bits: Optional[torch.Tensor], rate: float,
                    save: bool):
    """The forward of every tile: -> (out (out_rows, d), T (t_rows, d) or
    None), both in the plan's compute dtype.  bits: ``Keep``'s, or None
    (no dropout)."""
    if bits is not None and (bits.dtype != torch.int32
                             or tuple(bits.shape) != (plan.n_words,)
                             or bits.device != plan.device):
        raise ValueError(f"encode_fwd_cuda: bits must be int32 "
                         f"({plan.n_words},) on {plan.device}")
    out = torch.empty((plan.out_rows, plan.d), dtype=plan.cdt,
                      device=plan.device)
    t = torch.empty((plan.t_rows, plan.d), dtype=plan.cdt,
                    device=plan.device) if save else None
    _call("matcha_node_encode_fwd", plan.device, plan.table, plan.tiles_fwd,
          plan.n_fwd, bits, _scale(rate), int(bits is not None), plan.d,
          int(plan.cdt == torch.bfloat16), int(plan.x_bf16), out, t,
          int(plan.whole))
    encode_fwd_cuda.launches += 1
    return out, t


def encode_bwd_cuda(plan: Plan, bits: Optional[torch.Tensor], rate: float,
                    dout: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The backward of every tile: dout (out_rows, d) and the forward's T
    -> the flat f32 gradient of every w1 and w2 (``Plan.grad_views``)."""
    problems = []
    for name, a, rows in (("dout", dout, plan.out_rows),
                          ("t", t, plan.t_rows)):
        if a.dtype != plan.cdt or tuple(a.shape) != (rows, plan.d) \
                or a.device != plan.device or not a.is_contiguous() \
                or a.data_ptr() % 16:
            problems.append(f"{name} must be contiguous {plan.cdt} "
                            f"({rows}, {plan.d}) on {plan.device} at a "
                            f"16-byte boundary, got {a.dtype} "
                            f"{tuple(a.shape)} on {a.device}")
    if bits is not None and (bits.dtype != torch.int32
                             or tuple(bits.shape) != (plan.n_words,)
                             or bits.device != plan.device):
        problems.append(f"bits must be int32 ({plan.n_words},)")
    _refuse("encode_bwd_cuda", problems)
    grad = torch.empty((plan.n_grad,), dtype=torch.float32,
                       device=plan.device)
    _call("matcha_node_encode_bwd", plan.device, plan.table, plan.tiles_bwd,
          plan.n_bwd, bits, _scale(rate), int(bits is not None), plan.d,
          int(plan.cdt == torch.bfloat16), int(plan.x_bf16), dout, t, grad)
    encode_bwd_cuda.launches += 1
    return grad


class _NodeEncode(torch.autograd.Function):
    """K8 forward and backward; the weights' gradients in f32."""

    @staticmethod
    def forward(ctx, plan, features, bits, rate, *weights):
        out, t = encode_fwd_cuda(plan, bits, rate, save=True)
        ctx.plan, ctx.rate, ctx.features = plan, rate, features
        ctx.save_for_backward(bits, t, *weights)
        return out

    @staticmethod
    def backward(ctx, dout):
        bits, t = ctx.saved_tensors[:2]
        dout = dout.contiguous()
        if dout.data_ptr() % 16:     # the kernel copies its rows 16 bytes at a time
            dout = dout.clone()
        grad = encode_bwd_cuda(ctx.plan, bits, ctx.rate, dout, t)
        w1, w2 = ctx.plan.grad_views(grad)
        return (None, None, None, None, *w1, *w2)


def node_encode(plan: Plan, features, bits: Optional[torch.Tensor],
                rate: float, w1s, w2s) -> torch.Tensor:
    """The encoded rows of every chromosome (the plan's layout) on the
    card, with autograd's backward into w1s and w2s where they need it.
    features, w1s and w2s are the tensors the plan was made from."""
    if torch.is_grad_enabled() and any(w.requires_grad
                                       for w in list(w1s) + list(w2s)):
        return _NodeEncode.apply(plan, tuple(features), bits, rate, *w1s,
                                 *w2s)
    return encode_fwd_cuda(plan, bits, rate, save=False)[0]


keep_cuda.launches = 0
encode_fwd_cuda.launches = 0
encode_bwd_cuda.launches = 0


# ------------------------------------------------------------ plain models
def keep_plain(u: torch.Tensor, rows: int, first: int, width: int,
               rate: float) -> torch.Tensor:
    """The keep test K8's keep entry packs, for one chromosome: rows
    min(first + i, m - 1) (i < rows), columns < width of its (m, m) draw u,
    ``u < float32(1 - rate)`` -> bool (rows, width)."""
    m = u.shape[-1]
    idx = torch.clamp(first + torch.arange(rows, device=u.device),
                      max=m - 1)
    return u[idx, :width] < torch.tensor(_threshold(rate),
                                         dtype=torch.float32)


def pack_bits(keep: torch.Tensor) -> torch.Tensor:
    """bool (rows, width) -> int32 (rows, ceil(width / 32)) on keep's
    device: bit j of word w of a row is column 32w + j."""
    rows, width = keep.shape
    words = (width + 31) // 32
    k = torch.zeros((rows, 32 * words), dtype=torch.int64,
                    device=keep.device)
    k[:, :width] = keep
    w = (k.view(rows, words, 32)
         << torch.arange(32, device=keep.device)).sum(-1)
    return (w - (w >= 2 ** 31).long() * 2 ** 32).to(torch.int32)


def unpack_bits(bits: torch.Tensor, width: int) -> torch.Tensor:
    """``pack_bits``' inverse: int32 (rows, words) -> bool (rows, width)."""
    b = (bits.long().cpu() & 0xFFFFFFFF)
    k = (b[..., None] >> torch.arange(32)) & 1
    return k.reshape(bits.shape[0], -1)[:, :width].bool()


def node_encode_plain(features, w1s, w2s, cdt: torch.dtype,
                      keeps: Optional[List[torch.Tensor]], rate: float,
                      whole: bool) -> torch.Tensor:
    """K8's forward as the eager chain computes it: per chromosome X~ =
    where(keep, x / (1 - rate), 0) in cdt, tanh(X~ w1) w2; keeps: bool
    (rows, width) per chromosome, or None.  -> the chromosomes' rows in
    order, after a zero row when ``whole``."""
    blocks = []
    for c, (x, w1, w2) in enumerate(zip(features, w1s, w2s)):
        x = x.to(cdt)
        if keeps is not None:
            x = torch.where(keeps[c].to(x.device), x / (1.0 - rate),
                            torch.zeros((), dtype=cdt, device=x.device))
        blocks.append(torch.tanh(x @ w1.to(cdt)) @ w2.to(cdt))
    if whole:
        blocks.insert(0, torch.zeros((1, blocks[0].shape[1]), dtype=cdt,
                                     device=blocks[0].device))
    return torch.cat(blocks)
