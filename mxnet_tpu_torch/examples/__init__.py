"""Runnable examples of the PyTorch port (``example/``'s counterparts):
``word_lm``, the LSTM word language model; ``train_imagenet``, ResNet
ImageNet-style training; ``mnist_gluon``, the MNIST MLP."""
