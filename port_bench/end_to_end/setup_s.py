"""Set-up: from the process's start (before torch is imported) to the
end of the warm-up job: imports, the kernel library's build or load, the
solver's constants, the input pool and one job of the cell's shapes."""

UNIT = "s"


def read(window):
    return window.setup_seconds
