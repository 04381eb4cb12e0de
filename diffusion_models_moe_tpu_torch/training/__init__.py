"""ReLUfication fine-tuning (PyTorch port): the train step and its loop."""
