"""The work counts against hand-counted shapes."""

import math

import pytest

from portbench.core import registry
from portbench.core.trace import PEAK_BYTES, PEAK_FLOPS, bound_s

D, HEADS = 64, 8
HD = D * HEADS                     # 512: eight heads of 64


def call(E, L, elem=2):
    return {"E": E, "L": L, "d": D, "hd": HD, "elem": elem,
            "dtype": "bfloat16"}


@pytest.mark.parametrize("E,L", [(1, 3), (5_000, 5), (8_192, 4)])
def test_attention_forward_counts_every_head(E, L):
    flops, nbytes = registry.load_module("work", "attn_fwd").work(call(E, L))
    # per token: q, k, v projections 3 x 2 x 64 x 512, fc1 2 x 512 x 64,
    # scores and a @ v 2 x 2 x L x 512
    per_token = 3 * 2 * 64 * 512 + 2 * 512 * 64 + 4 * L * 512
    assert flops == E * L * per_token
    # x in, y out (bf16); f32 wq, wk, wv, fc1 and 7 LayerNorm-sized vectors
    assert nbytes == 2 * E * L * 64 * 2 + 4 * (4 * 64 * 512 + 7 * 64)


def test_attention_backward_counts():
    flops, nbytes = registry.load_module("work", "attn_bwd").work(
        call(10, 5, elem=4))
    assert flops == 10 * (2 * 5 * 64 * 512 * 11 + 12 * 25 * 512)
    assert nbytes == 3 * 10 * 5 * 64 * 4 + 2 * 4 * (4 * 64 * 512 + 7 * 64)


def test_scatter_is_bytes():
    flops, nbytes = registry.load_module("work", "scatter").work(
        {"T": 114_688, "d": 64, "n": 3_068, "elem": 2,
         "dtype": "bfloat16"})
    assert nbytes == 114_688 * 64 * 2 + 114_688 * 4 + 3_068 * 64 * 2
    assert bound_s(flops, nbytes, "bfloat16") == nbytes / PEAK_BYTES


def test_model_flops_by_hand():
    m = registry.load_module("work", "model")
    bins, d, hd = [3, 2], 4, 8
    rows = {2: 1, 3: 2}
    # encoder: 2 n^2 d (frozen input) + 2 n d^2; attr: 2 (N+1)(C+1) d
    frozen_in = 2 * 9 * 4 + 2 * 4 * 4 + 2 * 6 * 3 * 4
    rest = 2 * 3 * 16 + 2 * 2 * 16
    common = 2 * d * d + 4 * d * d + 2 * d
    tok = (1 * 2 * (common + 2 * d * hd + 2 * hd * d)
           + 2 * 3 * (common + 6 * d * hd + 2 * hd * d + 4 * 3 * hd))
    assert m.step_flops(bins, d, hd, rows, train=False) == frozen_in + rest \
        + tok
    recon = 2 * 6 * d * (5 / 2)
    assert math.isclose(m.step_flops(bins, d, hd, rows, train=True),
                        2 * frozen_in + 3 * (rest + tok + recon))


def test_peaks_are_the_h100_sxm_dense_rates():
    assert PEAK_FLOPS["bfloat16"] == 989e12
    assert PEAK_BYTES == 3.35e12
