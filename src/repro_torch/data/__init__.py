"""Tokenizer shared with the reference."""
