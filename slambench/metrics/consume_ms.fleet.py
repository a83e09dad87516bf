"""Host ms a frame inside FastSlamPipeline._consume (the chunk's results,
the Mapper, the loop-closure joins and the chunk dictionary's fetch),
from the harness span around the call, over every stream."""


def read(ctx):
    return ctx.span_ms_per_frame("consume")
