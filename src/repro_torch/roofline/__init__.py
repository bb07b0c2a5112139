"""Roofline tick-cost model for the serving engine."""
