"""Step builders (the train step on one device)."""
