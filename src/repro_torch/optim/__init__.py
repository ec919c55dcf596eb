"""Optimizers over parameter trees."""
