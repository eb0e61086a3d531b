"""flash_attention_roofline.serve (%): B1's share of its roofline in the
traced batch cycle (``colonybench.roofline``): the prefill's calls of
``repro_torch::flash_attention``."""

from colonybench import roofline
from colonybench.reference import counts


def read(run: dict) -> float | None:
    return roofline.share(run, "flash_attention", counts.flash_attention_least)
