"""Loop utilities: progress reporting and early stopping."""
