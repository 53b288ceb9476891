"""Operation and byte counts of the port's kernels, and the card's peaks, kept with the benchmark."""
