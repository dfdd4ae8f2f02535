"""``python -m commander_tpu_torch param.txt [options]`` (run.main)."""
from .run import main

if __name__ == "__main__":
    main()
