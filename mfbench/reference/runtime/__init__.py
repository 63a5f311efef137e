"""The pose node's crop."""
