from .model_server import main

main()
