"""Training and evaluation runners."""
