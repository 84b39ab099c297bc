"""prepare_s: host seconds to prepare the block through the port, once a
run: ParamLayout, SchurKernel, the band plan (ops/bandplan), ObsData on
the device and the step function, ending in a synchronise.  Moves
setup_s."""


def read(ctx):
    return ctx.stages.get("prepare_s")
