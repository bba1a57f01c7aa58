"""Work of the table gather's gradient (K3 and the cast back) for one call:
T cotangent rows of width d summed into n table rows.  Bytes: the rows and
their int32 ids read once, the (n, d) gradient written once in the
cotangent's dtype (``chip_smoke.py:k3_timing``'s count, with the output in
the dtype the op returns).  Operations: T x d additions, never the bound."""


def work(call: dict):
    T, d, n, elem = call["T"], call["d"], call["n"], call["elem"]
    return T * d, T * d * elem + T * 4 + n * d * elem
