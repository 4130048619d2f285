"""Device ms a step of the D phase (`moegan.step.d_phase`: real logits with
R1, the no-grad fake, the fake and shuffled-text logits, the D backward),
from the program's spans (`harness.spans`): the span's timing events on
its stream, over the traced stretches' `moegan.step` spans."""

from perfbench.harness import spans


def read(ctx):
    return spans.device_ms_per_root(spans.recorded(), spans.STEP, ("moegan.step.d_phase",))
