"""The synthetic data pipeline."""
