"""The benchmark's own code: the yardstick that program changes do not move."""
