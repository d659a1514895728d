"""Closed-loop clients, one module per traffic ``loop`` key."""
