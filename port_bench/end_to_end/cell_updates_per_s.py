"""Grid cells x steps (x members) of every job that passed in the window,
over the window's time (first job's start to last job's end), in millions
a second."""

UNIT = "Mcell-updates/s"


def read(window):
    if window.seconds <= 0:
        return None
    return window.work / window.seconds / 1e6
