"""The 95th percentile of the latency of the traced window's scoring requests
outside the profiled stretch, in ms: the wait on one call, from the call to
the returned array."""


def read(records):
    if records.get("kind") != "score":
        return None
    return records.get("request_ms_p95")
