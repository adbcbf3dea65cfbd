"""msm_grouped_roofline (kernels): the share of its bound that
``k_msm_accumulate_grouped`` reaches: the bucket fills of the batch's two
grouped MSMs (the circulant's products, N groups of l points and k sets,
and the G1 transform, k groups of N points and N sets) at the frozen window
width (``roofline_fk20.accumulate_work``), over the kernel's traced time a
batch.  None on a program without the kernel."""

from ..roofline_fk20 import accumulate_work, roofline_pct


def read(record):
    return roofline_pct(record, r"^k_msm_accumulate_grouped\b",
                        accumulate_work)
