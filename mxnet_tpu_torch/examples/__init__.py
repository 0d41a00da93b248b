"""Runnable examples of the PyTorch port (``example/``'s counterparts):
``word_lm``, the LSTM word language model."""
