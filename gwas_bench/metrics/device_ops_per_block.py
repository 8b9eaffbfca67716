"""Device operations per SNP block (ops): kernels, copies and sets that
torch.profiler saw on the device in the traced window, over the SNP blocks
it streamed.  None when the trace holds no device operation."""


def read(ctx):
    ops = ctx.reduced.device_ops
    return ops / ctx.blocks if ops else None
