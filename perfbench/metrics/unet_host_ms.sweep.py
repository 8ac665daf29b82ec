"""Host milliseconds from a UNet call's entry to its return, averaged over the
window's calls: the cost of enqueuing one call."""


def read(run):
    p = run["probe"]
    return 1000.0 * p["unet_s"] / p["calls"] if p["calls"] else None
