"""The yardstick: the metrics' arithmetic, kept with the benchmark so that
it cannot move with the program."""
