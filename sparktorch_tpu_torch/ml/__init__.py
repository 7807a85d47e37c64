"""Spark-ML-style Params, the local DataFrame, the model transformer and pipelines."""
