"""The paper's cost/delay model and the reuse policy built on it."""
