"""The recon loss in row blocks and tables handed in already cut to a rank's
rows (``parallel.mesh.frozen_row_blocks``), on the CPU.

* ``recon_loss_node`` (``_ReconBlocks``, the backward decoding each block
  again) in one block and, with ``RECON_BLOCK_BYTES`` patched small, in
  several equals the per-token oracle ``recon_loss_with_chrom`` (held
  against the JAX package in ``test_torch_forward_buckets.py``): the loss
  and every gradient (the node rows', the decoder's weight and bias), on
  inter_z with and without the f_max pad columns, with the bf16 decode
  operands, for every chromosome and on f32 and bf16 node tables;
* ``frozen_row_blocks`` names the rows ``shard_frozen`` keeps, for every
  rank of model axes 1 to 4, and ``holds_rank_blocks`` tells whole tables
  from a rank's blocks and refuses a cut that is not the mesh's;
* on spawned gloo worlds of 1 x 2 and 1 x 4 ranks, a Trainer given its
  rank's blocks (with the pad columns, and without) keeps them as they are
  (no copy) and trains the same seeded step as the same mesh given whole
  tables, also with the recon decoded in blocks.
"""

import numpy as np
import pytest
import torch

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.parallel import distributed as pd
from matcha_tpu_torch.parallel import mesh as pm
from matcha_tpu_torch.sampler.bloom import build_bloom_dict
from matcha_tpu_torch.sampler.negative import ChromTable
from matcha_tpu_torch.train import runtime as tr


def _problem():
    rng = np.random.default_rng(5)
    genome = GenomeBins(["chr1", "chr2", "chr3"],
                        [30_000_000, 22_000_000, 15_000_000], 1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    inter = rng.random((n, n)).astype(np.float32)
    dims = th.ModelDims(dim=16, n_head=4, num_chroms=3, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = th.init_model(torch.Generator().manual_seed(0), dims, sizes,
                           device="cpu")
    frozen = th.build_frozen_tables(genome, intra + intra.T, inter,
                                    device="cpu")
    buckets = {k: (np.stack([np.sort(rng.choice(np.arange(1, n + 1), k,
                                                replace=False))
                             for _ in range(24)]).astype(np.int32),
                   (rng.random(24) + 0.5).astype(np.float32))
               for k in (2, 3, 4)}
    return genome, dims, params, frozen, buckets


def _padded(frozen):
    f_max = max(f.shape[1] for f in frozen.features)
    return frozen._replace(inter_z=torch.nn.functional.pad(frozen.inter_z,
                                                           (0, f_max)))


def _recon_and_grads(params, frozen, dims, x, r, oracle=False):
    """The recon loss of chromosome r over the tokens x of a random node
    table and its gradients (decoder weight, bias, table): per node
    (``recon_loss_node``), or with ``oracle`` per token
    (``recon_loss_with_chrom`` on the tokens' rows, gathered in f32)."""
    dec = params["embed"]["recon"][r]
    leaves = [dec["w"].detach().clone().requires_grad_(True),
              dec["b"].detach().clone().requires_grad_(True)]
    w = leaves[0]
    if oracle and th._recon_decode_bf16():
        w = w.to(torch.bfloat16).float()
    p = {**params, "embed": {**params["embed"], "recon": [
        {"w": w, "b": leaves[1]} if c == r else d
        for c, d in enumerate(params["embed"]["recon"])]}}
    table = torch.randn(dims.num_nodes + 1, dims.dim,
                        generator=torch.Generator().manual_seed(r),
                        dtype=dims.cdt).requires_grad_(True)
    if oracle:
        loss = th.recon_loss_with_chrom(p, frozen, dims, x, table.float()[x],
                                        r)
    else:
        loss = th.recon_loss_node(p, frozen, dims, x, table, r)
    loss.backward()
    return [loss.detach()] + [t.grad for t in leaves] + [table.grad]


@pytest.mark.parametrize("bf16_decode", [False, True])
@pytest.mark.parametrize("pad_columns", [False, True])
def test_blocked_recon_equals_one_block(monkeypatch, pad_columns,
                                        bf16_decode):
    """One block and several against each other, and both against the
    per-token oracle.  With the bf16 decode the oracle takes the same bf16
    operands: the decoder's weight and tanh's output rounded through
    autograd casts, which round their gradients alike; and its tokens are
    every node once, since the oracle rounds each token's gradient where
    the per-node decode rounds the node's sum."""
    _, dims, params, frozen, _ = _problem()
    if pad_columns:
        frozen = _padded(frozen)
    monkeypatch.setattr(th, "_RECON_BF16", bf16_decode)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.integers(0, dims.num_nodes + 1, 300))
    x_oracle = (torch.as_tensor(rng.permutation(dims.num_nodes + 1))
                if bf16_decode else x)
    f_max = max(f.shape[1] for f in frozen.features)

    def one_and_blocked(tokens, r):
        with telemetry.unit("step") as one_unit:
            one = _recon_and_grads(params, frozen, dims, tokens, r)
        with monkeypatch.context() as m, \
                telemetry.unit("step") as blocked_unit:
            # blocks of the node rows at chromosome r's own width, the last
            # short
            m.setattr(th, "RECON_BLOCK_BYTES", 4 * f_max * 7)
            blocked = _recon_and_grads(params, frozen, dims, tokens, r)
        assert one_unit.counts["recon_blocks"] == 1
        assert blocked_unit.counts["recon_blocks"] > 1
        return one, blocked

    for r in range(dims.num_chroms):
        one, blocked = one_and_blocked(x, r)
        assert float(one[0]) > 0
        for a, b in zip(one, blocked):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
        if bf16_decode:
            one, blocked = one_and_blocked(x_oracle, r)
        with monkeypatch.context() as m:
            if bf16_decode:
                tanh = torch.tanh
                m.setattr(torch, "tanh",
                          lambda t: tanh(t).to(torch.bfloat16).float())
            want = _recon_and_grads(params, frozen, dims, x_oracle, r,
                                    oracle=True)
        for a, b, c in zip(want, one, blocked):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(c, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [0, 1, 2])
def test_recon_loss_node_equals_the_per_token_oracle(r, dtype):
    """The per-node loss of chromosome r on an f32 or a bf16 node table
    (its gradient cast back to the table's dtype) against the per-token
    oracle: tokens drawn with repeats, so each node's weight is its count."""
    _, dims, params, frozen, _ = _problem()
    dims = dims._replace(compute_dtype=dtype)
    x = torch.as_tensor(np.random.default_rng(2).integers(
        0, dims.num_nodes + 1, 300))
    want = _recon_and_grads(params, frozen, dims, x, r, oracle=True)
    got = _recon_and_grads(params, frozen, dims, x, r)
    assert float(want[0]) > 0 and got[3].dtype == dims.cdt
    for a, b in zip(want, got):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_the_blocked_recon_on_bf16_rows_returns_their_dtype(monkeypatch):
    _, dims, params, frozen, _ = _problem()
    dims = dims._replace(compute_dtype="bfloat16")
    monkeypatch.setattr(th, "RECON_BLOCK_BYTES", 4 * 30 * 4)
    x = torch.arange(1, dims.num_nodes + 1)
    loss, gw, gb, gt = _recon_and_grads(params, frozen, dims, x, 1)
    assert gt.dtype == torch.bfloat16 and gw.dtype == torch.float32
    assert torch.isfinite(loss) and gt.abs().sum() > 0


class _FakeMesh:
    def __init__(self, m, i):
        self.shape = {"data": 1, "model": m}
        self.model_index = i


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_frozen_row_blocks_are_the_rows_shard_frozen_keeps(m):
    _, _, _, frozen, _ = _problem()
    widths = [f.shape[1] for f in frozen.features]
    n_ids = frozen.chrom_of_node.shape[0]
    for i in range(m):
        mesh = _FakeMesh(m, i)
        kept = pm.shard_frozen(frozen, mesh)
        want = pm.frozen_row_blocks(widths, n_ids, m, i)
        for f, got, (lo, hi) in zip(frozen.features, kept.features,
                                    want["features"]):
            block = torch.zeros((hi - lo, f.shape[1]))
            block[:max(0, min(hi, f.shape[0]) - lo)] = f[lo:hi]
            assert torch.equal(got, block)
        lo, hi = want["inter_z"]
        block = torch.zeros((hi - lo, frozen.inter_z.shape[1]))
        block[:max(0, min(hi, n_ids) - lo)] = frozen.inter_z[lo:hi]
        assert torch.equal(kept.inter_z, block)
        assert pm.holds_rank_blocks(kept, mesh) == (m > 1)
        assert not pm.holds_rank_blocks(frozen, mesh)


def test_holds_rank_blocks_refuses_another_cut():
    _, _, _, frozen, _ = _problem()
    two = pm.shard_frozen(frozen, _FakeMesh(2, 0))
    with pytest.raises(ValueError, match="model axis of 4"):
        pm.holds_rank_blocks(two, _FakeMesh(4, 0))
    with pytest.raises(ValueError, match="model axis of 1"):
        pm.holds_rank_blocks(two, None)


def _blocks(frozen, mesh, pad_columns):
    """This rank's blocks, cut from the whole tables as a caller that builds
    only its rows would draw them."""
    widths = [f.shape[1] for f in frozen.features]
    n_ids = frozen.chrom_of_node.shape[0]
    want = pm.frozen_row_blocks(widths, n_ids, mesh.shape["model"],
                                mesh.model_index)

    def cut(a, lo, hi):
        out = torch.zeros((hi - lo,) + tuple(a.shape[1:]), dtype=a.dtype)
        out[:max(0, min(hi, a.shape[0]) - lo)] = a[lo:hi]
        return out

    inter = _padded(frozen).inter_z if pad_columns else frozen.inter_z
    return frozen._replace(
        features=tuple(cut(f, lo, hi) for f, (lo, hi) in
                       zip(frozen.features, want["features"])),
        inter_z=cut(inter, *want["inter_z"]))


def _step(genome, dims, params, frozen, buckets, mesh):
    blooms = build_bloom_dict({k: e for k, (e, _) in buckets.items()},
                              device="cpu")
    t = tr.Trainer(params, frozen, dims,
                   ChromTable.from_genome(genome, device="cpu"),
                   tr.TrainSettings(alpha=1.0, beta=0.5), blooms=blooms,
                   seed=11, mesh=mesh)
    aux = t.train_step({k: (torch.as_tensor(e), torch.as_tensor(w))
                        for k, (e, w) in buckets.items()})
    return t, {"bce": aux["bce"], "recon": aux["recon"],
               "pred": aux["pred"],
               "params": [p.detach().clone() for p in tr._leaves(t.params)]}


def _blocks_rank(rank, dev, n_model, tmp):
    torch.set_num_threads(1)
    mesh = pm.make_mesh(1, n_model)
    genome, dims, params, frozen, buckets = _problem()
    out = {}
    _, out["whole"] = _step(genome, dims, params, frozen, buckets, mesh)
    for pad in (True, False):
        given = _blocks(frozen, mesh, pad)
        t, out[f"blocks_pad{pad}"] = _step(genome, dims, params, given,
                                           buckets, mesh)
        out[f"kept_pad{pad}"] = (
            t.frozen.inter_z.data_ptr() == given.inter_z.data_ptr()
            and all(a.data_ptr() == b.data_ptr() for a, b in
                    zip(t.frozen.features, given.features)))
    f_max = max(f.shape[1] for f in frozen.features)
    th.RECON_BLOCK_BYTES = 4 * f_max * 3
    _, out["blocks_blocked_recon"] = _step(genome, dims, params,
                                           _blocks(frozen, mesh, True),
                                           buckets, mesh)
    torch.save(out, f"{tmp}/rank{rank}.pt")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ctxs = {}
    for m in (2, 4):
        tmp = tmp_path_factory.mktemp(f"blocks1x{m}")
        ctxs[m] = (tmp, pd.spawn(_blocks_rank, m, m, str(tmp), join=False))
    got = {}
    for m, (tmp, ctx) in ctxs.items():
        while not ctx.join():
            pass
        got[m] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                  for r in range(m)]
    return got


def _same(a, b, **tol):
    for key in ("bce", "recon", "pred"):
        torch.testing.assert_close(b[key], a[key], **tol)
    for x, y in zip(a["params"], b["params"]):
        torch.testing.assert_close(y, x, **tol)


@pytest.mark.parametrize("m", [2, 4])
def test_rank_blocks_train_the_step_of_whole_tables(worlds, m):
    for out in worlds[m]:
        assert out["kept_padTrue"] and out["kept_padFalse"]
        # the same rows and chromosome r's own columns: the same bits,
        # whether or not the given blocks carry the pad columns
        _same(out["whole"], out["blocks_padTrue"], rtol=0, atol=0)
        _same(out["whole"], out["blocks_padFalse"], rtol=0, atol=0)
        _same(out["whole"], out["blocks_blocked_recon"], rtol=1e-5,
              atol=1e-6)
    for out in worlds[m][1:]:
        _same(worlds[m][0]["whole"], out["whole"], rtol=0, atol=0)
