"""Host ms a frame inside FastSlamPipeline.dispatch (the chunk driver and
the VO step), from the harness span around the call, for the one
stream."""


def read(ctx):
    return ctx.span_ms_per_frame("dispatch")
