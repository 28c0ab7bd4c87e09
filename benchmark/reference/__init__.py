"""The plain reference of Cube R-CNN: plain PyTorch, float32, no kernel,
graph or cache, importing nothing of the program. Frozen copies of the
port's plain modules at commit 5a24e3a, each naming its source."""
