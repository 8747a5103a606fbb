"""Seeded numpy data streams and the anytime pipeline of the port."""
