"""``setup_s``: seconds from the process's start to the first timed
frame: torch and CUDA start, the scene, the ``Renderer`` and the
warm-up with any graph capture."""


def read(window):
    return window.setup_s
