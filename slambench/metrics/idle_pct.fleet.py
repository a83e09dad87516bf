"""The share of the traced window in which no operation ran on the card,
over the union of every stream's kernel, copy and set intervals."""


def read(ctx):
    return ctx.idle_pct()
