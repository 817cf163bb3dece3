"""Tools that measure the benchmark itself: the control and repeated runs."""
