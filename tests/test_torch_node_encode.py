"""K8, the node-table encode (``ops/node_encode.py``), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it against
the eager chain there).  Here:

  * every wrapper refuses what the kernel does not take before the library
    is loaded;
  * ``encode_node_table`` on the CPU (the eager chain, K8's plain version)
    equals a frozen copy of the code before K8, bit for bit: the batched and
    the per-chromosome layouts, train and eval, and a 1 x 4 model axis's
    rank 3, whose last rows are pad rows that read the clipped draw row;
  * the plain model of K8's indexing (the draw row of each of a rank's rows,
    the clip, the packed bits, ``u < float32(1 - rate)``) equals the eager
    chain in f32;
  * the K8 path itself, with each C entry replaced by an emulation that
    reads the plan's table, tiles and pointers as the kernel does, equals
    the eager chain in f32 (forward and both gradients) in every layout,
    also with the draws packed in several runs (``KEEP_GROUP_BYTES``);
  * a patched ``rand`` sees the same draws, in the same order and shapes,
    on both paths;
  * ``telemetry.kernel_launches()`` lists K8's counters.
"""

import ctypes
from typing import Dict, Optional

import numpy as np
import pytest
import torch

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.device import to_device
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.models import modules as tm
from matcha_tpu_torch.ops import node_encode as ne

RATE = 0.2


# ---------------------------------------------------- the code before K8
def _encode_before(params: Dict, frozen, dims, *,
                   generator: Optional[torch.Generator] = None,
                   train: bool = False) -> torch.Tensor:
    """``encode_node_table`` as it was before K8 (the module's helpers
    looked up at call time, so the tests' patches reach them)."""
    cdt = dims.cdt
    if "table" in params["embed"]:
        table = params["embed"]["table"].clone()
        table[0] = 0.0
        return table.to(cdt)
    if dims.feature_dropout_mode == "per_occurrence":
        train = False
    mesh = th.active_data_mesh()
    sharded = th._model_sharded(mesh)
    feats = frozen.features
    widths = [f.shape[1] for f in feats]
    rows = [f.shape[0] for f in feats]
    R, W = max(rows), max(widths)
    rate = dims.feature_dropout
    drop = train and generator is not None and rate > 0.0
    zero_row = torch.zeros((1, dims.dim), dtype=cdt, device=feats[0].device)

    def global_rows(c, n, top):
        return np.minimum(mesh.model_index * rows[c] + np.arange(n), top - 1)

    if len(feats) > 1 and len(feats) * W * W * 4 <= (64 << 20):
        x = torch.stack([torch.nn.functional.pad(
            f.to(cdt), (0, W - f.shape[1], 0, R - f.shape[0]))
            for f in feats])
        if drop:
            keep = th.rand(generator, (len(feats), W, W), x.device) \
                < 1.0 - rate
            if sharded:
                keep = keep[to_device(np.arange(len(feats))[:, None],
                                      x.device),
                            to_device(np.stack([global_rows(c, R, W) for c in
                                                range(len(feats))]),
                                      x.device)]
            else:
                keep = torch.nn.functional.pad(keep, (0, 0, 0, R - W),
                                               value=True)
            x = torch.where(keep, x / (1.0 - rate),
                            torch.zeros((), dtype=cdt, device=x.device))
        w1 = torch.stack([torch.nn.functional.pad(
            p["w1"].to(cdt), (0, 0, 0, W - p["w1"].shape[0]))
            for p in params["embed"]["ae"]])
        w2 = torch.stack([p["w2"].to(cdt)
                          for p in params["embed"]["ae"]])
        h = torch.bmm(torch.tanh(torch.bmm(x, w1)), w2)
        local = h.reshape(len(feats) * R, dims.dim)
        offsets = [c * R for c in range(len(feats))]
    else:
        gens = th.split_generator(generator if drop else None, len(feats))
        blocks = []
        for c, x in enumerate(feats):
            ae = params["embed"]["ae"][c]
            x = tm.dropout(x.to(cdt), rate, train, gens[c],
                           (widths[c], to_device(global_rows(
                               c, rows[c], widths[c]), x.device))
                           if sharded else None)
            h = torch.tanh(x @ ae["w1"].to(cdt)) @ ae["w2"].to(cdt)
            blocks.append(h if sharded else h[:x.shape[1]])
        if not sharded:
            return torch.cat([zero_row] + blocks, dim=0)
        local = torch.cat(blocks)
        offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).tolist()
    size = local.shape[0]
    if sharded:
        local = th.all_gather_rows(local, mesh.model_group)
    flat_idx = to_device(np.concatenate(
        [(g // rows[c]) * size + offsets[c] + g % rows[c]
         for c, g in ((c, np.arange(w)) for c, w in enumerate(widths))]),
        local.device)
    return torch.cat([zero_row, local[flat_idx]], dim=0)


# ------------------------------------------------------------- problems
# batched: the JAX package's one padded chain (C W^2 4 <= 64 MiB); loop:
# per chromosome (a 2,400-bin chromosome passes the gate)
LAYOUTS = {"batched": [130, 70, 45], "loop": [2400, 150, 70]}


class _FakeMesh:
    """Model rank ``index`` of a 1 x M mesh, without a process group (the
    all-gather is patched)."""

    def __init__(self, m: int, index: int):
        self.shape = {"data": 1, "model": m}
        self.model_index = index
        self.model_group = None


def _problem(layout: str, dim: int = 16, seed: int = 0, mesh=None):
    """(params, frozen, dims) with random corrcoef-like tables; under
    ``mesh`` the tables hold its rank's block of padded rows, as
    ``parallel.mesh.shard_frozen`` keeps them."""
    sizes = LAYOUTS[layout]
    g = torch.Generator().manual_seed(seed)
    dims = th.ModelDims(dim=dim, n_head=4, feature_dropout=RATE,
                        num_chroms=len(sizes), num_nodes=sum(sizes))
    params = th.init_model(g, dims, sizes, device="cpu")
    feats = []
    for n in sizes:
        f = torch.rand((n, n), generator=g) * 2 - 1
        if mesh is not None:
            m, i = mesh.shape["model"], mesh.model_index
            per = -(-n // m)
            f = torch.nn.functional.pad(f, (0, 0, 0, per * m - n))
            f = f[i * per:(i + 1) * per].clone()
        feats.append(f)
    n_ids = sum(sizes) + 1
    frozen = th.FrozenTables(
        features=tuple(feats), attr_table=torch.zeros((n_ids, 1)),
        inter_z=torch.zeros((1, 1)),
        chrom_of_node=torch.zeros((n_ids,), dtype=torch.int32),
        chrom_bounds=torch.zeros((len(sizes), 2), dtype=torch.int32))
    return params, frozen, dims


@pytest.fixture
def on_mesh(monkeypatch):
    """Install rank 3 of a 1 x 4 model axis: the all-gather tiles the
    rank's rows four times (every node id then reads rank 3's row at its
    local position, on both sides alike)."""
    mesh = _FakeMesh(4, 3)
    monkeypatch.setattr(th, "active_data_mesh", lambda: mesh)
    monkeypatch.setattr(th, "all_gather_rows",
                        lambda local, group: local.repeat(4, 1))
    return mesh


# ------------------------------------------------- the frozen copy (CPU)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("sharded", [False, True])
def test_cpu_encode_equals_the_code_before_k8(layout, train, sharded,
                                              request):
    mesh = request.getfixturevalue("on_mesh") if sharded else None
    params, frozen, dims = _problem(layout, mesh=mesh)
    got = th.encode_node_table(params, frozen, dims, train=train,
                               generator=torch.Generator().manual_seed(5))
    want = _encode_before(params, frozen, dims, train=train,
                          generator=torch.Generator().manual_seed(5))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_cpu_encode_bf16_equals_the_code_before_k8():
    params, frozen, dims = _problem("batched")
    dims = dims._replace(compute_dtype="bfloat16")
    got = th.encode_node_table(params, frozen, dims, train=True,
                               generator=torch.Generator().manual_seed(2))
    want = _encode_before(params, frozen, dims, train=True,
                          generator=torch.Generator().manual_seed(2))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("sharded", [False, True])
def test_cpu_encode_trains_after_an_encode_in_inference_mode(layout, sharded,
                                                             request):
    """A scoring call (inference mode) and then a training step on the same
    tables: what the first encode keeps for the layout must not be an
    inference tensor that the step's backward cannot save."""
    mesh = request.getfixturevalue("on_mesh") if sharded else None
    params, frozen, dims = _problem(layout, mesh=mesh)
    with torch.inference_mode():
        th.encode_node_table(params, frozen, dims)
    w1 = params["embed"]["ae"][0]["w1"].requires_grad_(True)
    table = th.encode_node_table(params, frozen, dims, train=True,
                                 generator=torch.Generator().manual_seed(5))
    (grad,) = torch.autograd.grad(table.sum(), [w1])
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0


# ------------------------------------------------- the plain model (f32)
@pytest.mark.parametrize("rate", [0.1, 0.2, 0.3, 0.4, 0.7])
def test_keep_threshold_is_float32_of_one_minus_rate(rate):
    """The eager chain's ``u < 1.0 - rate`` on f32 uniforms is the kernel's
    ``u < float32(1 - rate)``, also at the threshold and next to it."""
    t = np.float32(1.0 - rate)
    edge = np.array([np.nextafter(t, np.float32(0)), t,
                     np.nextafter(t, np.float32(1))], np.float32)
    u = torch.cat([torch.from_numpy(edge),
                   torch.rand(10_000, generator=torch.Generator()
                              .manual_seed(1))])
    eager = u < 1.0 - rate
    plain = ne.keep_plain(u.view(1, -1).expand(u.numel(), -1), 1, 0,
                          u.numel(), rate)[0]
    assert torch.equal(eager, plain)
    assert eager[:3].tolist() == [True, False, False]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("sharded", [False, True])
def test_plain_model_of_the_indexing_equals_the_eager_chain(layout, sharded,
                                                            request,
                                                            monkeypatch):
    """Each rank row's draw row (min(first + i, m - 1)), its bits packed 32
    columns a word and unpacked, and the plain forward from them equal the
    eager encode's rows in f32."""
    mesh = request.getfixturevalue("on_mesh") if sharded else None
    params, frozen, dims = _problem(layout, mesh=mesh)
    draws = []

    def rand(gen, shape, device):
        u = _RAND(gen, shape, device)
        draws.append(u)
        return u
    monkeypatch.setattr(th, "rand", rand)
    monkeypatch.setattr(tm, "rand", rand)
    captured = {}
    if sharded:
        monkeypatch.setattr(th, "all_gather_rows", lambda local, group: (
            captured.setdefault("local", local), local.repeat(4, 1))[1])
    got = th.encode_node_table(params, frozen, dims, train=True,
                               generator=torch.Generator().manual_seed(7))
    feats = frozen.features
    rows = [f.shape[0] for f in feats]
    widths = [f.shape[1] for f in feats]
    C, R, W = len(feats), max(rows), max(widths)
    batched = layout == "batched"
    assert len(draws) == (1 if batched else C)
    first = 0 if mesh is None else mesh.model_index
    keeps = []
    for c in range(C):
        u = draws[0][c] if batched else draws[c]
        k = ne.keep_plain(u, rows[c], first * rows[c], widths[c], RATE)
        bits = ne.pack_bits(k)
        assert bits.shape == (rows[c], (widths[c] + 31) // 32)
        assert torch.equal(ne.unpack_bits(bits, widths[c]), k)
        keeps.append(ne.unpack_bits(bits, widths[c]))
    ae = params["embed"]["ae"]
    plain = ne.node_encode_plain(feats, [p["w1"] for p in ae],
                                 [p["w2"] for p in ae], torch.float32, keeps,
                                 RATE, whole=mesh is None)
    if mesh is None:
        torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)
        return
    local = captured["local"]
    off = 0
    for c in range(C):
        at = c * R if batched else off
        torch.testing.assert_close(local[at:at + rows[c]],
                                   plain[off:off + rows[c]], rtol=1e-6,
                                   atol=1e-6)
        off += rows[c]


_RAND = tm.rand


# -------------------------------------------- the K8 path, emulated (f32)
class _Emulator:
    """The three C entries of csrc/node_encode.cu in PyTorch, reading the
    plan's table, tiles and pointers as the kernel does.  Pointers in the
    table or the draw array resolve to the registered tensors that hold
    them."""

    def __init__(self):
        self.held = []
        self.calls = []

    def register(self, *ts):
        self.held += [t for t in ts if t is not None]

    def _at(self, ptr: int, n: int, dtype) -> torch.Tensor:
        for t in self.held:
            base = t.data_ptr()
            size = t.numel() * t.element_size()
            if base <= ptr < base + size and t.dtype == dtype:
                off = (ptr - base) // t.element_size()
                return t.reshape(-1)[off:off + n]
        raise AssertionError(f"pointer {ptr:#x} is no registered tensor's")

    @staticmethod
    def _field(table, c):
        return table[c * ne.NF:(c + 1) * ne.NF].tolist()

    def _x_tilde(self, f, table_dtype, cdt, bits, masked, scale, r0, r1,
                 k0, k1):
        x = self._at(f[ne.F_X], f[ne.F_ROWS] * f[ne.F_WIDTH],
                     table_dtype).view(f[ne.F_ROWS], f[ne.F_WIDTH])
        x = x[r0:r1, k0:k1].to(cdt)
        if masked:
            words = f[ne.F_WORDS]
            w = bits[f[ne.F_BITS]:f[ne.F_BITS] + f[ne.F_ROWS] * words]
            keep = ne.unpack_bits(w.view(-1, words)[r0:r1],
                                  f[ne.F_WIDTH])[:, k0:k1]
            x = torch.where(keep, x * scale, torch.zeros((), dtype=cdt))
        return x

    def __call__(self, entry, device, *args):
        self.calls.append(entry)
        getattr(self, entry)(*args)

    def matcha_node_encode_keep(self, table, c0, c1, u_addr, thr, bits,
                                total_words):
        ptrs = (ctypes.c_void_p * ne.MAXC).from_address(u_addr)
        assert total_words == sum(
            self._field(table, c)[ne.F_ROWS] * self._field(table, c)[
                ne.F_WORDS] for c in range(c0, c1))
        for c in range(c0, c1):
            f = self._field(table, c)
            m = f[ne.F_USTRIDE]
            u = self._at(ptrs[c], m * m, torch.float32).view(m, m)
            idx = torch.clamp(f[ne.F_UOFF] + torch.arange(f[ne.F_ROWS]),
                              max=f[ne.F_UTOP])
            keep = u[idx, :f[ne.F_WIDTH]] < torch.tensor(
                thr, dtype=torch.float32)
            n = f[ne.F_ROWS] * f[ne.F_WORDS]
            bits[f[ne.F_BITS]:f[ne.F_BITS] + n] = ne.pack_bits(keep).view(-1)

    def matcha_node_encode_fwd(self, table, tiles, n_tiles, bits, scale,
                               masked, d, is_bf16, x_bf16, out, tsave,
                               zero_row):
        cdt = torch.bfloat16 if is_bf16 else torch.float32
        tdt = torch.bfloat16 if x_bf16 else torch.float32
        if zero_row:
            out[0] = 0
        for i in range(n_tiles):
            c, rt = tiles[2 * i].item(), tiles[2 * i + 1].item()
            f = self._field(table, c)
            r0, r1 = rt * ne.TM, min((rt + 1) * ne.TM, f[ne.F_ROWS])
            x = self._x_tilde(f, tdt, cdt, bits, masked, scale, r0, r1, 0,
                              f[ne.F_WIDTH])
            w1 = self._at(f[ne.F_W1], f[ne.F_WIDTH] * d,
                          torch.float32).view(-1, d)
            w2 = self._at(f[ne.F_W2], d * d, torch.float32).view(d, d)
            t = torch.tanh(x @ w1.to(cdt))
            if tsave is not None:
                tsave[f[ne.F_T] + r0:f[ne.F_T] + r1] = t
            out[f[ne.F_OUT] + r0:f[ne.F_OUT] + r1] = t @ w2.to(cdt)

    def matcha_node_encode_bwd(self, table, tiles, n_tiles, bits, scale,
                               masked, d, is_bf16, x_bf16, dout, tsave,
                               grad):
        cdt = torch.bfloat16 if is_bf16 else torch.float32
        tdt = torch.bfloat16 if x_bf16 else torch.float32
        for i in range(n_tiles):
            c, jt = tiles[2 * i].item(), tiles[2 * i + 1].item()
            f = self._field(table, c)
            n = f[ne.F_ROWS]
            dh = dout[f[ne.F_OUT]:f[ne.F_OUT] + n].float()
            t = tsave[f[ne.F_T]:f[ne.F_T] + n].float()
            if jt < 0:
                grad[f[ne.F_GW2]:f[ne.F_GW2] + d * d] = (t.T @ dh).reshape(-1)
                continue
            w2 = self._at(f[ne.F_W2], d * d, torch.float32).view(d, d)
            g = (dh @ w2.T) * (1 - t * t)
            j0, j1 = jt * ne.TM, min((jt + 1) * ne.TM, f[ne.F_WIDTH])
            x = self._x_tilde(f, tdt, cdt, bits, masked, scale, 0, n, j0, j1)
            at = f[ne.F_GW1] + j0 * d
            grad[at:at + (j1 - j0) * d] = (x.float().T @ g).reshape(-1)


@pytest.fixture
def emulated(monkeypatch):
    """The K8 path on the CPU: ``takes`` says yes, the plan's table stays
    on the CPU (no CUDA check), and each launch runs the emulation."""
    emu = _Emulator()
    monkeypatch.setattr(ne, "takes", lambda feats, dim: True)
    monkeypatch.setattr(ne, "_check_plan", lambda *a: None)
    monkeypatch.setattr(ne, "_call", emu)
    monkeypatch.setattr(ne, "_PLANS", type(ne._PLANS)())
    orig = th.rand

    def rand(gen, shape, device):
        u = orig(gen, shape, device)
        emu.register(u)
        return u
    monkeypatch.setattr(th, "rand", rand)
    return emu


def _close_grads(got, want):
    """Each gradient within 1e-5 of its largest entry: f32 sums over up to
    2,400 rows in another order (the emulation's per-tile products against
    the eager chain's one product per chromosome)."""
    for a, b in zip(got, want):
        err = float((a - b).abs().max())
        assert err <= 1e-5 * float(b.abs().max()), (err, float(b.abs().max()))


def _grads(table, params, seed=3):
    """The gradients of w1 and w2 of every chromosome under a fixed random
    projection of the node table."""
    r = torch.randn(table.shape, generator=torch.Generator().manual_seed(seed))
    leaves = [p[k] for p in params["embed"]["ae"] for k in ("w1", "w2")]
    return torch.autograd.grad((table.float() * r).sum(), leaves)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dim", [16, 64])
def test_k8_path_emulated_equals_the_eager_chain(layout, train, dim,
                                                 emulated, monkeypatch):
    params, frozen, dims = _problem(layout, dim=dim)
    for p in params["embed"]["ae"]:
        p["w1"].requires_grad_(True)
        p["w2"].requires_grad_(True)
    emulated.register(*frozen.features,
                      *[p[k] for p in params["embed"]["ae"]
                        for k in ("w1", "w2")])
    want = _encode_before(params, frozen, dims, train=train,
                          generator=torch.Generator().manual_seed(9))
    got = th.encode_node_table(params, frozen, dims, train=train,
                               generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    _close_grads(_grads(got, params), _grads(want, params))
    # one forward and one backward launch; the keep bits in one run
    assert emulated.calls == (["matcha_node_encode_keep"] if train else []) \
        + ["matcha_node_encode_fwd", "matcha_node_encode_bwd"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_k8_path_emulated_on_a_rank_of_a_model_axis(layout, emulated,
                                                    on_mesh, monkeypatch):
    """Rank 3 of 4: its rows (the last ones pad rows reading the clipped
    draw row) through the emulated K8, against the eager chain, forward and
    gradients; the draws packed one run per chromosome."""
    monkeypatch.setattr(ne, "KEEP_GROUP_BYTES", 1)
    params, frozen, dims = _problem(layout, mesh=on_mesh)
    for p in params["embed"]["ae"]:
        p["w1"].requires_grad_(True)
        p["w2"].requires_grad_(True)
    emulated.register(*frozen.features,
                      *[p[k] for p in params["embed"]["ae"]
                        for k in ("w1", "w2")])
    want = _encode_before(params, frozen, dims, train=True,
                          generator=torch.Generator().manual_seed(4))
    got = th.encode_node_table(params, frozen, dims, train=True,
                               generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    _close_grads(_grads(got, params), _grads(want, params))
    n_keep = 1 if layout == "batched" else len(frozen.features)
    assert emulated.calls.count("matcha_node_encode_keep") == n_keep


def test_rand_sees_the_same_draws_on_both_paths(emulated, monkeypatch):
    """A patched ``rand`` (as the harness's recorder patches
    ``models.modules.rand`` and ``models.hypersagnn.rand``) sees the same
    shapes in the same order, with the same values, on the eager chain and
    on the K8 path."""
    for layout in sorted(LAYOUTS):
        params, frozen, dims = _problem(layout)
        emulated.register(*frozen.features,
                          *[p[k] for p in params["embed"]["ae"]
                            for k in ("w1", "w2")])
        seen = {}
        for name, fn in (("eager", _encode_before),
                         ("k8", th.encode_node_table)):
            draws = []
            inner = th.rand

            def rand(gen, shape, device, inner=inner, draws=draws):
                u = inner(gen, shape, device)
                draws.append((tuple(shape), u.clone()))
                return u
            monkeypatch.setattr(th, "rand", rand)
            monkeypatch.setattr(tm, "rand", rand)
            fn(params, frozen, dims, train=True,
               generator=torch.Generator().manual_seed(13))
            monkeypatch.setattr(th, "rand", inner)
            seen[name] = draws
        assert [s for s, _ in seen["eager"]] == [s for s, _ in seen["k8"]]
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(seen["eager"], seen["k8"]))
        n = len(frozen.features)
        assert len(seen["k8"]) == (1 if layout == "batched" else n)


def test_eval_draws_nothing_and_saves_nothing(emulated):
    """Without a generator (eval, scoring, the apps) the K8 path draws
    nothing and launches only the forward, without T."""
    params, frozen, dims = _problem("batched")
    emulated.register(*frozen.features,
                      *[p[k] for p in params["embed"]["ae"]
                        for k in ("w1", "w2")])
    with torch.no_grad():
        got = th.encode_node_table(params, frozen, dims)
    torch.testing.assert_close(got, _encode_before(params, frozen, dims),
                               rtol=1e-5, atol=1e-6)
    assert emulated.calls == ["matcha_node_encode_fwd"]


# --------------------------------------------------------- the wrappers
def _cpu_plan(layout="batched", dim=16):
    params, frozen, dims = _problem(layout, dim=dim)
    ae = params["embed"]["ae"]
    feats = frozen.features
    w = [f.shape[1] for f in feats]
    return ne.Plan(feats, [p["w1"] for p in ae], [p["w2"] for p in ae],
                   torch.float32, w, [0] * len(w), True), params, frozen


def _bad_plans():
    params, frozen, dims = _problem("batched")
    ae = params["embed"]["ae"]
    f, w1, w2 = list(frozen.features), [p["w1"] for p in ae], \
        [p["w2"] for p in ae]
    w = [x.shape[1] for x in f]
    z = [0] * len(f)
    t = torch.float32
    yield "cpu", (f, w1, w2, t, w, z, True), "takes CUDA tensors only"
    yield "f16 compute", (f, w1, w2, torch.float16, w, z, True), \
        "compute dtype must be"
    yield "bf16 weight", (f, [x.bfloat16() for x in w1], w2, t, w, z, True), \
        r"w1\[0\] must be contiguous f32"
    yield "w1 shape", (f, [x[:-1] for x in w1], w2, t, w, z, True), \
        r"w1\[1\] must be contiguous f32 \(70, 16\)"
    yield "w2 off a 16-byte boundary", (
        f, w1, [torch.zeros(x.numel() + 1)[1:].view(x.shape) for x in w2], t,
        w, z, True), r"w2\[0\] must be contiguous f32 \(16, 16\) on cpu at a "
    yield "strided table", (f[:1] + [x.t() for x in f[1:]], w1, w2, t, w,
                            z, True), r"features\[1\] must be a contiguous"
    yield "f64 table", ([x.double() for x in f], w1, w2, t, w, z, True), \
        "must be f32 or bf16"
    yield "narrow draw", (f, w1, w2, t, [x - 1 for x in w], z, True), \
        "draw must be at least as wide"
    yield "too many", (f * 30, w1 * 30, w2 * 30, t, w * 30, z * 30, True), \
        "takes 1 to 64 chromosomes"


@pytest.mark.parametrize("case", [c for c, _, _ in _bad_plans()])
def test_plan_refuses_before_loading_the_library(case, monkeypatch):
    monkeypatch.setattr(ne, "_library", lambda: pytest.fail("loaded"))
    args, why = {c: (a, m) for c, a, m in _bad_plans()}[case]
    with pytest.raises(ValueError, match="node_encode.plan") as err:
        ne.plan(*args)
    assert err.match(why)


def test_plan_refuses_a_width_k8_does_not_take(monkeypatch):
    monkeypatch.setattr(ne, "_library", lambda: pytest.fail("loaded"))
    params, frozen, _ = _problem("batched", dim=16)
    ae = params["embed"]["ae"]
    w1 = [torch.zeros(p["w1"].shape[0], 24) for p in ae]
    w2 = [torch.zeros(24, 24) for _ in ae]
    w = [f.shape[1] for f in frozen.features]
    with pytest.raises(ValueError, match="d must be one of"):
        ne.plan(frozen.features, w1, w2, torch.float32, w, [0] * 3, True)
    assert not ne.takes([torch.zeros(1)], 24)
    assert not ne.takes([torch.zeros(1)], 64)    # a CPU table


def _wrapper_cases():
    yield "keep: chromosomes", lambda p: ne.keep_cuda(
        p, 2, [torch.zeros(45, 45)] * 2, RATE,
        torch.zeros(p.n_words, dtype=torch.int32)), "keep_cuda"
    yield "keep: draw shape", lambda p: ne.keep_cuda(
        p, 0, [torch.zeros(130, 129)], RATE,
        torch.zeros(p.n_words, dtype=torch.int32)), "keep_cuda"
    yield "keep: draw dtype", lambda p: ne.keep_cuda(
        p, 0, [torch.zeros(130, 130, dtype=torch.float64)], RATE,
        torch.zeros(p.n_words, dtype=torch.int32)), "keep_cuda"
    yield "keep: bits", lambda p: ne.keep_cuda(
        p, 0, [torch.zeros(130, 130)], RATE,
        torch.zeros(p.n_words, dtype=torch.int64)), "keep_cuda"
    yield "fwd: bits", lambda p: ne.encode_fwd_cuda(
        p, torch.zeros(p.n_words + 1, dtype=torch.int32), RATE, True), \
        "encode_fwd_cuda"
    yield "bwd: dout shape", lambda p: ne.encode_bwd_cuda(
        p, None, RATE, torch.zeros(p.out_rows - 1, p.d),
        torch.zeros(p.t_rows, p.d)), "encode_bwd_cuda"
    yield "bwd: dout dtype", lambda p: ne.encode_bwd_cuda(
        p, None, RATE, torch.zeros(p.out_rows, p.d, dtype=torch.bfloat16),
        torch.zeros(p.t_rows, p.d)), "encode_bwd_cuda"
    yield "bwd: dout stride", lambda p: ne.encode_bwd_cuda(
        p, None, RATE, torch.zeros(p.d, p.out_rows).t(),
        torch.zeros(p.t_rows, p.d)), "encode_bwd_cuda"
    yield "bwd: dout off a 16-byte boundary", lambda p: ne.encode_bwd_cuda(
        p, None, RATE, torch.zeros(p.out_rows * p.d + 2)[2:].view(
            p.out_rows, p.d), torch.zeros(p.t_rows, p.d)), "16-byte boundary"
    yield "bwd: t rows", lambda p: ne.encode_bwd_cuda(
        p, None, RATE, torch.zeros(p.out_rows, p.d),
        torch.zeros(p.t_rows + 1, p.d)), "encode_bwd_cuda"


@pytest.mark.parametrize("case", [c for c, _, _ in _wrapper_cases()])
def test_wrappers_refuse_before_loading_the_library(case, monkeypatch):
    monkeypatch.setattr(ne, "_library", lambda: pytest.fail("loaded"))
    call, name = {c: (f, n) for c, f, n in _wrapper_cases()}[case]
    plan, _, _ = _cpu_plan()
    with pytest.raises(ValueError, match=name):
        call(plan)


def test_plan_layout():
    """The table of a whole node table: chromosome c's rows at 1 + the
    widths before it, T and bits in row order, the flat gradient's dW1 then
    dW2 blocks; forward tiles widest first, dW2 tiles last."""
    plan, params, frozen = _cpu_plan(dim=16)
    f = plan.fields
    assert f[:, ne.F_OUT].tolist() == [1, 131, 201]
    assert f[:, ne.F_T].tolist() == [0, 130, 200]
    assert f[:, ne.F_WORDS].tolist() == [5, 3, 2]
    assert f[:, ne.F_BITS].tolist() == [0, 650, 860]
    assert f[:, ne.F_GW1].tolist() == [0, 130 * 16, 200 * 16]
    assert f[:, ne.F_GW2].tolist() == [245 * 16 + 256 * c for c in range(3)]
    assert (plan.out_rows, plan.t_rows, plan.n_words, plan.n_grad) == (
        246, 245, 950, 245 * 16 + 3 * 256)
    fwd = plan.tiles_fwd.view(-1, 2).tolist()
    assert fwd == [[0, 0], [0, 1], [0, 2], [1, 0], [1, 1], [2, 0]]
    bwd = plan.tiles_bwd.view(-1, 2).tolist()
    assert bwd == [[0, 0], [0, 1], [0, 2], [1, 0], [1, 1], [2, 0],
                   [0, -1], [1, -1], [2, -1]]
    w1, w2 = plan.grad_views(torch.arange(plan.n_grad, dtype=torch.float32))
    assert [tuple(t.shape) for t in w1] == [(130, 16), (70, 16), (45, 16)]
    assert all(tuple(t.shape) == (16, 16) for t in w2)
    assert float(w2[0][0, 0]) == 245 * 16


def test_plans_are_kept_per_tables_and_layout(emulated):
    params, frozen, dims = _problem("batched")
    ae = params["embed"]["ae"]
    args = (frozen.features, [p["w1"] for p in ae], [p["w2"] for p in ae],
            torch.float32)
    w = [f.shape[1] for f in frozen.features]
    a = ne.plan(*args, w, [0] * 3, True)
    assert ne.plan(*args, list(w), [0] * 3, True) is a
    assert ne.plan(*args, w, [1] * 3, True) is not a


def test_plans_are_kept_per_weight_dtype_and_shape(emulated, monkeypatch):
    """A weight of another dtype or shape at a kept plan's weight address
    gets a plan of its own, checked anew, not the kept one."""
    checked = []
    monkeypatch.setattr(ne, "_check_plan", lambda *a: checked.append(a))
    params, frozen, _ = _problem("batched")
    ae = params["embed"]["ae"]
    f, w1, w2 = frozen.features, [p["w1"] for p in ae], \
        [p["w2"] for p in ae]
    w = [x.shape[1] for x in f]
    a = ne.plan(f, w1, w2, torch.float32, w, [0] * 3, True)
    bf16 = [x.view(torch.bfloat16) for x in w1]       # the same addresses
    b = ne.plan(f, bf16, w2, torch.float32, w, [0] * 3, True)
    c = ne.plan(f, w1, [x.view(8, 32) for x in w2], torch.float32, w,
                [0] * 3, True)
    assert len({id(a), id(b), id(c)}) == 3 and len(checked) == 3
    assert ne.plan(f, w1, w2, torch.float32, w, [0] * 3, True) is a
    assert len(checked) == 3


def test_kernel_launches_lists_k8():
    launches = telemetry.kernel_launches()
    assert launches["K8_fwd"] == ne.encode_fwd_cuda.launches
    assert launches["K8_bwd"] == ne.encode_bwd_cuda.launches
    assert launches["K8_keep"] == ne.keep_cuda.launches
