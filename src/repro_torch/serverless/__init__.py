"""Serverless platform model (instances, autoscaling, billing)."""
