from .decode import generate, sample_tokens, serve_step
