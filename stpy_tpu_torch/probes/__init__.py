"""Probes of the port: replays of the JAX package's diagnostic scripts on the card."""
