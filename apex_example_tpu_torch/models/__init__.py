"""Models of the port (GPT on post-LN BERT layers)."""
