"""The benchmark's own work counts: the floating-point operations and bytes
that a step, a chunk or a kernel's work requires, computed from the
configuration's widths and the sample counts of the traffic, never from
what a kernel launches. ``peaks`` holds the card's published rates."""
