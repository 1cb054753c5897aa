"""Signal ops of the port: wire decode, spectra, FFT passes, peaks."""
