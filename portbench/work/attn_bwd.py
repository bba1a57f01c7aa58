"""Work of the hyperedge attention backward (K2) for one call on E edges of
L tokens: a frozen copy of ``chip_smoke.py:attention_bwd_work`` at the
call's own widths.

Operations: the forward's q, k, v products, scores and a @ v recomputed,
then g @ fc1^T, fc1's gradient, the three attention gradients, the three
products back to x and the three projection gradients (2 L d hd x 11 and
12 L L hd per edge).  Bytes: x and g read once and dx written once in the
call's dtype, the f32 weights and LayerNorm parameters read once and their
gradients written once."""


def work(call: dict):
    E, L, d, hd = call["E"], call["L"], call["d"], call["hd"]
    flops = E * (2 * L * d * hd * 11 + 12 * L * L * hd)
    nbytes = 3 * E * L * d * call["elem"] + 2 * 4 * (4 * d * hd + 7 * d)
    return flops, nbytes
