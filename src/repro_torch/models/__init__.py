"""The dense decoder of the serving path."""
