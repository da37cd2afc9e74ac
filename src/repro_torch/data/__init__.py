"""Seeded, restartable data streams (``pipeline``): numpy, the reference's
batches bit for bit."""
