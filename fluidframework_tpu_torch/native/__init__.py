"""Native (C++) host components, built with g++ at first use."""
