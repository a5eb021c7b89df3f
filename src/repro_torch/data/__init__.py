"""Synthetic data for the port: the paper's context-sharing serving workload."""
