def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: runs only with a CUDA device")
