"""Applications of the PyTorch port: the word2vec trainer."""
