"""polys_per_s: polynomials committed and opened a second, every one whose
commitment, evaluation and proof reached the host in the window, over the
window's seconds (host clock, from the first batch's submission to the
last one's answers)."""


def read(record):
    return record.polys / record.window_s
