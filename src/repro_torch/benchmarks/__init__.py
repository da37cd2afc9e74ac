"""Measuring tools of the port that need a GPU (``staged_ablation``: where
the staged pass's time goes)."""
