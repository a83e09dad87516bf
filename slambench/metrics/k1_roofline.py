"""K1's share of its roofline: its calls' least time at the card's
peaks (slambench/roofline/k1.py) over its kernels' device time in the
trace."""


def read(ctx):
    return ctx.roofline(["k1"])
