"""Device ms a step of the two clipped AdamW updates (`moegan.step.d_adamw`
and `moegan.step.g_adamw`), from the program's spans (`harness.spans`):
their timing events on the stream, over the traced stretches'
`moegan.step` spans."""

from perfbench.harness import spans

NAMES = ("moegan.step.d_adamw", "moegan.step.g_adamw")


def read(ctx):
    return spans.device_ms_per_root(spans.recorded(), spans.STEP, NAMES)
