"""Host time outside any UNet call over the window, %: image loads, prompt
encoding, the samplers' and controller's work between calls, the VAE, the strips'
hand-off and its waits (the benchmark's spans around the UNet calls)."""


def read(run):
    p = run["probe"]
    if not p["calls"] or run["window_s"] <= 0:
        return None
    return 100.0 * (run["window_s"] - p["unet_s"]) / run["window_s"]
