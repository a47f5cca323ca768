"""The port's optimizer (AdamW) and error-feedback gradient compression."""
