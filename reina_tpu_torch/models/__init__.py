"""Comparison models beside the agent-based engine."""
