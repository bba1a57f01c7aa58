"""Work of the hyperedge attention forward (K1: LayerNorm -> q, k, v ->
diag-masked attention -> fc1) for one call on E edges of L tokens: a frozen
copy of ``chip_smoke.py:attention_work`` at the call's own widths.

Operations: the q, k, v and fc1 products (2 L d hd each, hd = n_head x
d_k), the scores and a @ v (2 L L hd each).  Bytes: x read once and the
output written once in the call's dtype, the f32 weights (4 d hd) and
LayerNorm parameters (7 d) read once."""


def work(call: dict):
    E, L, d, hd = call["E"], call["L"], call["d"], call["hd"]
    flops = E * (2 * L * d * hd * 3 + 2 * L * hd * d + 4 * L * L * hd)
    nbytes = 2 * E * L * d * call["elem"] + 4 * (4 * d * hd + 7 * d)
    return flops, nbytes
