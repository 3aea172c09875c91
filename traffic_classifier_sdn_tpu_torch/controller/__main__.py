from .switch import main

main()
