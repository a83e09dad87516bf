"""The share of the traced window in which no operation ran on the card,
for the one stream."""


def read(ctx):
    return ctx.idle_pct()
