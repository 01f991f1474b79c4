import sys

from . import serve

if __name__ == "__main__":
    sys.exit(serve())
