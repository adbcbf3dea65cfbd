"""msm_grouped_reduce_roofline (kernels): the share of its bound that the
grouped MSM's reduction, ``k_msm_window_sums_grouped`` and
``k_msm_horner_grouped``, reaches: the running sums and the fold of the
batch's two grouped MSMs at the frozen window width
(``roofline_fk20.reduce_work``), over their traced time a batch."""

from ..roofline_fk20 import reduce_work, roofline_pct


def read(record):
    return roofline_pct(
        record, r"^k_msm_(window_sums|horner)_grouped\b", reduce_work)
