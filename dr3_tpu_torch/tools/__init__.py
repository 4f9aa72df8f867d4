"""Measurement helpers for chip_smoke.py and the K1 comparison on the card
(timing, bounds); nothing on the port's path imports them."""
