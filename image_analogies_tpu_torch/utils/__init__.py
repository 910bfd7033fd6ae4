"""Evaluation and state helpers of the port."""
