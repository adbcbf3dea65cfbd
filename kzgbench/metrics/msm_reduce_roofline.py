"""msm_reduce_roofline (kernels): the share of its bound that
``msm_reduce``'s two kernels (``k_msm_window_sums``, ``k_msm_horner``)
reach: the bucket and window sums and the fold of the batch's MSMs at the
frozen window width (``roofline.reduce_work``), over their traced device
time a batch."""

from . import roofline_pct
from ..roofline import reduce_work


def read(record):
    return roofline_pct(record, r"^k_msm_(window_sums|horner)\b",
                        reduce_work)
