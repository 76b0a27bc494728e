"""Device ms a step of the dense closest point K5 (``ops/closest_point``:
``surface_distances_kernel`` and its ``tile_boxes_kernel`` pre-pass)."""

NAMES = ("surface_distances_kernel", "tile_boxes_kernel")


def read(view):
    secs, count = view.seconds_of(NAMES)
    return 1e3 * secs / view.steps if count else None
