"""Handlers that turn ColonyOS function specs into torch programs."""
