"""The plain reference of the benchmark: the posterior of the sBayes model
worked out again from the raw data, the configuration and the states the
program ended in, in float64 (or, for the control, in a lower precision).
Plain PyTorch and numpy; nothing of the program under test."""
