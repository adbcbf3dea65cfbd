"""msm_accumulate_roofline (kernels): the share of its bound that
``k_msm_accumulate`` reaches: the bucket fills of the batch's MSMs at the
benchmark's frozen window width (``roofline.accumulate_work``) at the
card's peaks, over the kernel's traced device time a batch."""

from . import roofline_pct
from ..roofline import accumulate_work


def read(record):
    return roofline_pct(record, r"^k_msm_accumulate\b", accumulate_work)
