"""PyTorch + CUDA port of news_recommendation_mind_tpu for NVIDIA Hopper.

Module names mirror the JAX package, which stays the reference this port
is held against. The port imports neither JAX nor the JAX package. Its
entry points (``serving.Recommender``, ``experiment.build_model``,
``evaluation.engine.encode_all_news``) run on the card unless the caller
passes ``device="cpu"``; the TPU kernels on their path are hand-written
CUDA kernels under ``csrc/``, built by ``ops/_build.py`` on first use.
"""
