"""Serving: the engine and the generator batch handler."""
