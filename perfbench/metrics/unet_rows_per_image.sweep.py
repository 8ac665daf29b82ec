"""UNet batch rows per edited image over the window (a count)."""


def read(run):
    p = run["probe"]
    return p["rows"] / run["images"] if p["calls"] and run["images"] else None
