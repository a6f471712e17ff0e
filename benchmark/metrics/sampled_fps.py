"""sampled_fps: sampled frames analysed to a finished result in the
window, over the window (closed-loop cells)."""


def read(cell, out):
    if not out.units:
        return None
    return sum(u.frames for u in out.units) / out.window_s
