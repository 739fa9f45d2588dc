"""Models of the port: the FL simulation CNN (`cnn`) and its layers."""
