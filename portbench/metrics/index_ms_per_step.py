"""Device ms a step of the closest-point index (``ops/surface_index``):
the coarse pass K3/K8 (``nearest_vertices_kernel``) and the refine K4
(``refine_shortlist_kernel``)."""

NAMES = ("nearest_vertices_kernel", "refine_shortlist_kernel")


def read(view):
    secs, count = view.seconds_of(NAMES)
    return 1e3 * secs / view.steps if count else None
