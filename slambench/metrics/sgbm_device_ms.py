"""Device ms a frame of the kernels launched inside the harness's
annotation around SGBM (tpuslam_torch.kernels.sgbm.sgbm, as the fused
front end calls it), over the calls in the trace."""


def read(ctx):
    return ctx.annotated_ms_per_frame("sgbm")
