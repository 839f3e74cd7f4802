"""``frame_ms``: the window's wall time over the frames completed in it,
in ms.  The window ends on a device sync (a loop's last call syncs)."""


def read(window):
    if window.frames == 0:
        return None
    return window.wall_s * 1e3 / window.frames
