"""The port's token data pipeline."""
