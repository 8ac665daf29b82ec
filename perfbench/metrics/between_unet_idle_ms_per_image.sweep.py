"""Device-idle milliseconds an image while the main thread is outside every
``pnpi.unet.call`` span, over the profiled batch: image loads, prompt
encoding, the samplers' and the controller's work between calls, the VAE,
the strips' hand-off and its waits. The note gives the split's coverage:
the idle under no ``pnpi.*`` span, and the idle inside plus outside the UNet
calls against the traced idle."""
from perfbench import program_spans


def read(run):
    return program_spans.between_unet_idle_ms_per_image(run)


def note(run):
    return program_spans.idle_note(run, "between_unet_idle_ms_per_image.sweep")
