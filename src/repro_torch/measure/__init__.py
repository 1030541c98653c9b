"""Timers and sized microbenchmarks on the card."""
