"""Traffic mixes: ``<mix>.json`` parameter files, read by the driver each
names, and the generators they share."""
