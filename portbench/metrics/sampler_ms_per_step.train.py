"""Host milliseconds per training step inside the sampler
(``train.runtime._sample_all_negatives``), its host synchronisations
included, over the traced window's steps outside the profiled stretch."""


def read(records):
    if records.get("kind") != "train":
        return None
    return records.get("sampler_ms_per_step")
