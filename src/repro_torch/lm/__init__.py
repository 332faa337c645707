"""LM serving on the card: prefill and greedy decode."""
