"""Device ms a step of the ICP target direction's assembly kernel
(``ops/assemble_cuda.target_assembly``: ``target_assembly_kernel``), which
builds that direction's M and right-hand side."""

NAMES = ("target_assembly_kernel",)


def read(view):
    secs, count = view.seconds_of(NAMES)
    return 1e3 * secs / view.steps if count else None
