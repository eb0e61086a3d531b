"""rwkv6_wkv_roofline.serve (%): B2's share of its roofline in the traced
batch cycle (``colonybench.roofline``): the prefill's calls of
``repro_torch::rwkv6_chunked``."""

from colonybench import roofline
from colonybench.reference import counts


def read(run: dict) -> float | None:
    return roofline.share(run, "rwkv6_wkv", counts.wkv_least)
