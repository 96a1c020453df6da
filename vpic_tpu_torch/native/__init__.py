"""Host-side native helpers (file I/O), built with the system C++
compiler at first use."""
