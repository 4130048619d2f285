"""Device ms a step of the G phase (`moegan.step.g_phase`: the generator
forward, D on the fake, the losses, the G backward), from the program's
spans (`harness.spans`): the span's timing events on its stream, over the
traced stretches' `moegan.step` spans."""

from perfbench.harness import spans


def read(ctx):
    return spans.device_ms_per_root(spans.recorded(), spans.STEP, ("moegan.step.g_phase",))
